"""App layer: offline HTML reports + streamlit-gated interactive UI."""
from .report import render_report, write_report
