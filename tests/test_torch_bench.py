"""The port's bench, chip scripts and graft entry against the repo's JAX
ones, on the CPU.

* ``make_signal`` and ``GAINS`` equal ``bench.py``'s, bit for bit;
* the correctness section at 2 x 0.25 s on the CPU: z and the spectra
  >= 60 dB against the port's oracle (its own gate) and > 90 dB against
  the JAX ``AudioPipeline`` on the same inputs (its flat program with the
  spectra, bf16x3 "fast" products: ~100 dB; the port is float32);
* the record builder emits exactly ``bench.py``'s JSON keys;
* ``scripts/config_matrix``'s 79 configurations are the JAX script's;
* ``graft_entry.entry(device="cpu")``'s program against the JAX
  ``entry()`` program's z: > 90 dB.

``bench.py``, ``__graft_entry__.py`` and ``scripts/config_matrix.py`` are
read from the repo root (the first two import no jax at module level; the
script only as source, since importing it turns on a compile cache).
"""
from __future__ import annotations

import ast
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

import dsp_audio_project_tpu as jpkg
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu_torch import bench, graft_entry
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.scripts import config_matrix

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_root(name: str):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_signal_and_gains_match_bench_py():
    jb = load_root("bench")
    assert bench.GAINS == jb.GAINS
    assert (bench.SECONDS, bench.FS) == (jb.SECONDS, jb.FS)
    for n in (1000, 44100):
        a, b = bench.make_signal(n, bench.FS), jb.make_signal(n, jb.FS)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_correctness_section_matches_oracle_and_jax():
    acc = bench.check_accuracy(0.25, 2, device="cpu")
    assert acc["route"] == "cat"
    assert acc["snr_z"] >= 60 and acc["snr_spectra"] >= 60
    jp = jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=160, M=147),
        eq=jpkg.EQConfig.from_gains(bench.GAINS),
        kernels=JKernelConfig(src_fast=True, eq_fast=True)))
    jz, _, jm = jp._forward_spectra(jnp.asarray(acc["xs"]), bench.FS)
    assert np.asarray(jz).shape == acc["z"].shape == (2, 12000)
    assert snr_db(np.asarray(jz).ravel(), acc["z"].ravel()) > 90
    for a, b in zip(jm, acc["mags"]):
        assert np.asarray(a).shape == b.shape == (2, 1025)
        assert snr_db(np.asarray(a).ravel(), b.ravel()) > 90


def _json_keys(node: ast.Dict) -> dict:
    """{key: sub-keys or None} of a dict literal, through ``**`` parts."""
    out = {}
    for k, v in zip(node.keys, node.values):
        if k is None:                       # **({...} if cond else {})
            for sub in ast.walk(v):
                if isinstance(sub, ast.Dict):
                    out.update(_json_keys(sub))
            continue
        out[k.value] = _json_keys(v) if isinstance(v, ast.Dict) else None
    return out


def test_record_has_bench_py_keys():
    tree = ast.parse((ROOT / "bench.py").read_text())
    dumps = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
             and getattr(c.func, "attr", None) == "dumps"]
    assert len(dumps) == 1
    want = _json_keys(dumps[0].args[0])
    rec = bench.record(1.6e10, 2.0e5, 0.1, 0.12, 3.0e8)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    assert keys(rec) == want
    assert rec["metric"] == "src_eq_fft_chain_input_samples_per_sec_per_chip"
    assert rec["vs_baseline"] == round(1.6e10 / 2.0e5, 2)


def test_config_matrix_is_the_jax_scripts():
    tree = ast.parse((ROOT / "scripts" / "config_matrix.py").read_text())
    consts = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    subset = consts["subset_extra"] | {(160, 147)}
    want = set()
    for L in range(1, 9):
        for M in range(1, 9):
            want.add((L, M, "mix"))
            if (L, M) in subset:
                want |= {(L, M, "flat"), (L, M, "extreme")}
    want |= {(160, 147, g) for g in ("mix", "flat", "extreme")}
    got = config_matrix.configurations()
    assert len(got) == 79 == len(want)
    assert {(L, M, g) for L, M, g, _ in got} == want
    sets = {"mix": consts["MIX"], "flat": consts["FLAT"],
            "extreme": consts["EXTREME"]}
    assert all(gains == sets[g] for _, _, g, gains in got)


def test_graft_entry_matches_jax_entry():
    fn, (x,) = graft_entry.entry(device="cpu")
    assert x.shape == (2, 44100) and x.device.type == "cpu"
    z, mags = fn(x)
    jfn, (jx,) = load_root("__graft_entry__").entry()
    assert np.array_equal(np.asarray(jx), x.numpy())
    jz, _ = jfn(jx)
    jz = np.asarray(jz)
    got = z.reshape(2, -1)[:, :jz.shape[-1]].numpy()
    assert jz.shape == (2, 48000)
    assert snr_db(jz.ravel(), got.ravel()) > 90
    assert all(m.shape == (2, 1025) for m in mags)
