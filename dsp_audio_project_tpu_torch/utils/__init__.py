"""Device rule, precision pinning, stage spans, timing and device profiles.

* ``device``: where a call runs (the card unless the caller asks for the
  CPU) and the per-device cache of host-built tables;
* ``precision``: float32 contractions at full precision (TF32 off);
* ``profiling``: ``trace_stage`` spans (``torch.profiler.record_function``),
  ``StageTimer`` and the HBM roofline share;
* ``benchmarking``: CUDA-event timing of calls on the card;
* ``deviceprof``: device time by kernel from ``torch.profiler``.

The JAX package's ``utils/compcache.py`` and ``utils/df32.py`` have no
counterpart here.  ``compcache`` points XLA's persistent compile cache at
the repo; the port compiles nothing through XLA, and its own build cache is
the kernel libraries of ``kernels/_build.py`` (keyed by a hash of the
sources).  ``df32`` emulates float64 with float32 pairs on a chip that has
no float64; the H100 has float64, and the port's device builder of the
dynamic EQ uses it (``ops/eq_dynamic.py``).
"""
