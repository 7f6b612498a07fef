"""The port's chip scripts, each run as
``python -m dsp_audio_project_tpu_torch.scripts.<name>``:

* ``config_matrix``: the 79 UI configurations through ``__call__`` and the
  cat forward, each >= 60 dB against the oracle;
* ``rfft_sweep``: the routed rfft kernel against the torch butterfly and
  ``torch.fft.rfft`` at the large spectrogram sizes;
* ``stream_sweep``: the sharded stream's super-step size against the
  one-shot chain;
* ``dyn_pipeline``: the steady, serial and pipelined dynamic-serving loops;
* ``pod_scaling``: the sharded fused chain over every card, one process a
  card (``torchrun``, NCCL) or one process over them all, its scaling
  efficiency against a single-card time taken in the same run.

Counterparts of the repo's ``scripts/`` of those names.  Two more time
ablation copies of one kernel source on the card, and have no JAX
counterpart: ``fir_variants`` (the FIR body, ``csrc/fir_cat.cu``) and
``state_variants`` (the state solve's kernels, ``csrc/group_states.cu``:
float64 against float32 sums, beside the dense product it replaced).
``design_phases`` stamps and times the phases of the device gain
builder's kernels (``csrc/eq_design.cu``, or any other copy of it), and
``library_bounds`` computes, from shapes alone, the bounds of the cuBLAS
products the port still calls.  The JAX package's
TPU probes (``mosaic_capability``, ``layout_probe``, ``mxu_issue_probe``,
``split_ab``, ``cat_ab``, ``flat_vs_frames``) and ``sharded_real_chip`` have
none: ``chip_smoke.py`` [time] and [sharded] answer their questions on the
card.
"""
