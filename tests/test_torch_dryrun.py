"""The dry-run accounting (``repro_torch.launch.dryrun``) against closed forms
and full traces, and the roofline (``launch.roofline``) against the
reference's.

* FLOPs of a reduced dense step equal 2·M·N·K summed over the layer's
  products and attention's two: remat ``'none'`` and ``'dots'`` read
  forward + backward (3×), ``'full'`` adds one forward of every layer but
  its last product (the MLP down-projection), which non-reentrant
  checkpointing's early stop never recomputes; a prefill reads one forward.
* Two traces of the model's own step, at two and at three units of
  layers (a layer; for the hybrid a pattern period, its tail in both),
  extended to the depth equal a full-depth trace (``loss_fn`` and
  ``torch.autograd.grad`` over per-layer leaves, as the trainer takes
  them; ``prefill``; ``decode_step``) at 4 layers (the hybrid: 14, four
  pattern periods and a 2-layer tail): FLOPs, bytes and activation peaks
  exactly.
* rwkv's step extrapolated from one and two WKV chunks equals its trace at
  three: FLOPs exactly, bytes within 0.5 %, peaks within 2 %.
* The collective tally equals its formula on a 2 × 2 mesh.
* ``roofline_row`` equals the reference's on the same numbers (its three
  constants patched to the H100's; dense, moe and hybrid records, the
  reference's holding the outside plus one layer); the encoder-decoder and
  rwkv rows hold to the closed form.
"""
import dataclasses
import json
import math
import os

import pytest
import torch

import repro.launch.roofline as ref_roofline
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.distributed import ShardMesh
from repro_torch.launch import dryrun, roofline
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import abstract_params, get_model, input_specs
from repro_torch.sharding.rules import PROFILES
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import layer_views
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

B, S = 2, 16


def _small(arch, **kw):
    cfg = reduce_for_smoke(get_config(arch))
    return dataclasses.replace(cfg, n_layers=14 if cfg.family == "hybrid" else 4, **kw)


def _totals(cfg, shape, attn_impl="auto"):
    traced = dryrun.trace_cell(cfg, shape, attn_impl)
    return traced["flops"], traced["bytes"], traced["peak"]


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_train_flops_closed_form(remat):
    cfg = _small("qwen2.5-3b", remat=remat)  # tied head, qkv bias (no FLOPs)
    T, d, H, Kv, hd, f, V, L = (B * S, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff,
                                cfg.vocab, cfg.n_layers)
    mm = lambda m, k, n: 2 * m * k * n  # noqa: E731
    layer = (mm(T, d, H * hd) + 2 * mm(T, d, Kv * hd) + mm(T, H * hd, d)  # q, k, v, out
             + 2 * mm(T, d, f) + mm(T, f, d)  # up, gate, down
             + 2 * B * H * mm(S, hd, S))  # q·kᵀ and p·v
    head = mm(T, d, V)
    want = 3 * (L * layer + head)
    if remat == "full":
        want += L * (layer - mm(T, f, d))
    assert _totals(cfg, ShapeSpec("x", S, B, "train"))[0] == want
    assert _totals(cfg, ShapeSpec("x", S, B, "prefill"))[0] == L * layer + mm(B, d, V)


def _full_trace(cfg, shape):
    """The whole step at full depth, traced on meta tensors."""
    params, _ = abstract_params(cfg)
    batch = input_specs(cfg, shape)
    model = get_model(cfg)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             dtype_of(cfg.compute_dtype), device="meta")

    def run():
        if shape.kind == "train":
            views = layer_views(params, lambda t: t.detach().requires_grad_())
            with torch.enable_grad():
                loss, _ = model.loss_fn(views, batch)
                return list(torch.autograd.grad(loss, tree_leaves(views), allow_unused=True,
                                                materialize_grads=True))
        with torch.no_grad():
            if shape.kind == "prefill":
                return dryrun._tensors(model.prefill(params, batch)[1])
            model.decode_step(params, batch["token"], cache, shape.seq_len - 1)
        return []

    return dryrun._trace(run)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma-2b", "olmoe-1b-7b", "rwkv6-3b",
                                  "recurrentgemma-9b", "qwen2-vl-72b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_units_times_depth_equal_a_full_trace(arch, kind):
    cfg = _small(arch)
    shape = ShapeSpec("x", 32, 4, kind)
    full = _full_trace(cfg, shape)
    assert _totals(cfg, shape) == (full["flops"], full["bytes"], full["peak"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_rwkv_extrapolation_equals_its_trace(monkeypatch, kind):
    """At 3 WKV chunks; the chunk cut from 256 to 16 tokens keeps it quick
    (the extrapolation reads the chunk from ``models.rwkv``)."""
    from repro_torch.models import rwkv

    monkeypatch.setattr(rwkv, "WKV_CHUNK", 16)
    cfg = reduce_for_smoke(get_config("rwkv6-3b"))
    shape = ShapeSpec("x", 48, 2, kind)
    got = dryrun._step_at(cfg, shape, "auto")
    want = dryrun._step(cfg, shape, "auto")
    assert got["extrapolated_from"] == [16, 32]
    assert got["flops"] == want["flops"]
    assert abs(got["bytes"] / want["bytes"] - 1) <= 5e-3
    assert abs(got["peak"] / want["peak"] - 1) <= 2e-2
    with pytest.raises(ValueError, match="multiple of 16"):
        dryrun._step_at(cfg, dataclasses.replace(shape, seq_len=50), "auto")


def test_collectives_formula_on_a_2x2_mesh():
    """Reduced qwen2.5-3b (float32 weights), train profile on data 2 × model 2,
    remat 'full', B 4 × S 16: every weight with an embed_fsdp dimension is
    gathered over data (twice for layer weights: forward and recompute) and
    its gradient reduce-scattered; the out- and down-projections (heads 4 and
    d_ff 96 split over model) all-reduce [B/2, S, d] three times a layer."""
    cfg = _small("qwen2.5-3b")
    mesh = ShardMesh(["meta"] * 4, shape=(2, 2), axis_names=("data", "model"))
    shape = ShapeSpec("x", 16, 4, "train")
    d, H, Kv, hd, f, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab,
                             cfg.n_layers)
    layer_w = [d * H * hd, 2 * d * Kv * hd, H * hd * d, 3 * d * f]  # all split over model too
    gather = 4 * (V * d // 2 + 2 * L * sum(n // 2 for n in layer_w))
    scatter = 4 * (V * d // 4 + L * sum(n // 4 for n in layer_w))
    reduce = 3 * L * 2 * (4 // 2) * 16 * d * 4
    params, axes = abstract_params(cfg)
    coll, layer = dryrun._collectives(cfg, shape, mesh, "train", params, axes)
    assert coll == {"all-gather": gather, "reduce-scatter": scatter, "all-reduce": reduce,
                    "total": gather + scatter + reduce}
    assert layer["all-reduce"] == reduce // L
    # serving: weights replicated over data, one all-reduce per contraction
    coll, _ = dryrun._collectives(cfg, ShapeSpec("x", 16, 4, "prefill"), mesh, "serve", params,
                                  axes)
    assert coll["all-gather"] == coll["reduce-scatter"] == 0
    assert coll["all-reduce"] == L * 2 * (4 // 2) * 16 * d * 4
    # the pod's gradient mean adds every gradient block
    pod = ShardMesh(["meta"] * 8, shape=(2, 2, 2), axis_names=("pod", "data", "model"))
    coll, _ = dryrun._collectives(cfg, shape, pod, "train_pod", params, axes)
    st = dryrun._state(cfg, shape, pod, PROFILES["train_pod"], params, axes)
    assert coll["all-reduce"] == 3 * L * 2 * 1 * 16 * d * 4 + st["grad_bytes"]


def _ref_row(monkeypatch, rec, n):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(ref_roofline, name, getattr(roofline, name))
    return ref_roofline.roofline_row(rec, n)


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "train_4k"), ("granite-8b", "decode_32k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("recurrentgemma-9b", "train_4k")])
def test_roofline_row_matches_reference(monkeypatch, arch, shape):
    cfg = get_config(arch)
    out_f, out_b, out_c = 7.0e12, 3.0e11, 2.0e9  # the outside, per device
    lay_f, lay_b, lay_c = 1.3e12, 4.0e10, 5.0e8  # one layer
    base = dict(arch=arch, shape=shape, ok=True, mesh={"data": 16, "model": 16},
                memory={"bytes_per_device": 5 * 2**30})
    ref = dict(base, cost={"flops": out_f + lay_f, "bytes": out_b + lay_b},
               collectives={"total": out_c + lay_c},
               layer={"flops": lay_f, "bytes": lay_b, "collectives": {"total": lay_c}})
    # what the reference reconstitutes from them: the hybrid's layer record is
    # one block of its period, and its trip count the periods
    n = cfg.n_layers
    if cfg.family == "hybrid":
        n = (cfg.n_layers // len(cfg.block_pattern)) * len(cfg.block_pattern)
    port = dict(base, cost={"flops": out_f + n * lay_f, "bytes": out_b + n * lay_b},
                collectives={"total": out_c + n * lay_c})
    if cfg.family == "hybrid":  # the reference subtracts a whole period once
        P = len(cfg.block_pattern)
        port["cost"] = {"flops": out_f + lay_f - P * lay_f + n * lay_f,
                        "bytes": out_b + lay_b - P * lay_b + n * lay_b}
        port["collectives"] = {"total": out_c + lay_c - P * lay_c + n * lay_c}
    want = _ref_row(monkeypatch, ref, 256)
    got = roofline.roofline_row(port, 256)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12) if isinstance(v, float) else got[k] == v, k


@pytest.mark.parametrize("arch,shape", [("whisper-tiny", "prefill_32k"), ("rwkv6-3b", "train_4k")])
def test_roofline_closed_form(arch, shape):
    """No scan correction and no recurrence term: the whole step's numbers
    over the H100's peaks."""
    rec = dict(arch=arch, shape=shape, ok=True, cost={"flops": 3.0e13, "bytes": 2.0e11},
               collectives={"total": 1.0e9}, memory={"bytes_per_device": 2**31})
    row = roofline.roofline_row(rec, 512)
    assert row["t_compute_s"] == 3.0e13 / 989e12
    assert row["t_memory_s"] == 2.0e11 / 3.35e12
    assert row["t_collective_s"] == 1.0e9 / 50e9
    assert row["dominant"] == "memory" and row["bytes_per_device_gib"] == 2.0
    cfg = get_config(arch)
    tokens = {"prefill_32k": 32 * 32768, "train_4k": 256 * 4096}[shape]
    per = cfg.flops_per_token_train() / (1 if shape == "train_4k" else 3)
    assert row["useful_ratio"] == pytest.approx(per * tokens / (3.0e13 * 512), rel=1e-12)
    assert row["roofline_fraction"] == pytest.approx(per * tokens / 512 / 989e12
                                                     / (2.0e11 / 3.35e12), rel=1e-12)
    assert roofline.roofline_row(dict(rec, ok=False), 512) is None


def test_main_writes_cells_and_roofline_reads_them(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "both",
                        "--out", out, "--jobs", "2"]) == 0
    assert dryrun.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--mesh", "single",
                        "--out", out, "--no-layer-cost"]) == 0
    files = sorted(os.listdir(out))
    assert files == ["qwen2.5-3b__decode_32k__pod1.json", "qwen2.5-3b__decode_32k__pod2.json",
                     "rwkv6-3b__long_500k__pod1.json"]
    rec = json.load(open(os.path.join(out, files[1])))
    assert rec["ok"] and rec["profile"] == "serve_pod" and rec["kind"] == "decode"
    assert {"arch", "shape", "kind", "mesh", "profile", "memory", "cost", "collectives",
            "layer"} <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "bytes_per_device"} <= set(rec["memory"])
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["cost"]["flops"] * 512 == rec["cost"]["flops_global"]
    assert rec["collectives"]["total"] == sum(v for k, v in rec["collectives"].items()
                                              if k != "total")
    assert "layer" not in json.load(open(os.path.join(out, files[2])))
    capsys.readouterr()
    assert roofline.main(["--dryrun-dir", out, "--mesh", "both"]) == 0
    text = capsys.readouterr().out
    assert "Roofline (pod1, 256 H100s)" in text and "Roofline (pod2, 512 H100s)" in text
    assert text.count("| qwen2.5-3b | decode_32k |") == 2
    assert roofline.main(["--dryrun-dir", out, "--mesh", "both", "--compact"]) == 0
    grid = capsys.readouterr().out.splitlines()
    assert grid[0] == "| arch (pod1 / pod2) | decode_32k | long_500k |"
    assert grid[2].startswith("| qwen2.5-3b | mem/mem ") and grid[2].endswith("| — |")
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", out, "--layer-cost-only"]) == 0


def test_kernel_attention_counts_its_dense_equivalent():
    cfg = _small("qwen2.5-3b")
    shape = ShapeSpec("x", 128, 4, "prefill")
    dense = dryrun.trace_cell(cfg, shape, "dense")
    kern = dryrun.trace_cell(cfg, shape, "kernel")
    assert kern["flops"] == dense["flops"]
    assert kern["peak"] < dense["peak"]
    from repro_torch.kernels import ops

    assert ops.flash_attention.__name__ == "flash_attention"  # the stand-in is gone


def test_the_account_runs_on_meta_only():
    with pytest.raises(RuntimeError, match="meta tensors only"):
        dryrun._trace(lambda: [torch.ones(2) + 1])
    full = ShardMesh(["meta"], shape=(1, 1), axis_names=("data", "model"))
    rec = dryrun.lower_cell(_small("gemma-2b"), ShapeSpec("x", 64, 2, "train"), full)
    mem = rec["memory"]
    assert mem["bytes_per_device"] == (mem["param_bytes"] + mem["grad_bytes"] + mem["opt_bytes"]
                                       + mem["input_bytes"] + mem["activation_bytes"])
    assert math.prod(rec["mesh"].values()) == 1 and rec["collectives"]["total"] == 0
