from .chain import AudioPipeline, design_tables, tables_from_numpy
from .graph import Chain, Clip, Equalize, Gain, Normalize, Resample, Stage

__all__ = ["AudioPipeline", "Chain", "Clip", "Equalize", "Gain",
           "Normalize", "Resample", "Stage", "design_tables",
           "tables_from_numpy"]
