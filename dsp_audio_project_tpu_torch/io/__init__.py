"""I/O layer: WAV/AIFF/FLAC codecs, the native WAV engine and host-side
signal conditioning (numpy in, numpy out)."""
from .signal_io import export_wav, load_signal
from .wavio import read_wav, write_wav
