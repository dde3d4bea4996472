"""The port's CPU scale-out tools -- the dry run, the collective
calibration and the H100 roofline -- against hand counts and the JAX
package's analytic model.

 - Dry run: stablelm-1.6b ``decode_32k`` at its published config on the
   fake 16 x 16 mesh gives a record with the JAX package's keys, and its
   argument bytes a rank equal the local-shard bytes the specs give the
   params, cache and tokens; one sharded matmul on a fake 2 x 2 mesh gives
   the hand-counted collective and FLOPs.
 - Calibrate: at a smoke config on a fake 4 x 4 mesh the two-point fit of
   the collectives (R = 1, 2) reproduces the direct count exactly.
 - Roofline: ``flops_model`` and ``bytes_model`` equal the JAX package's
   for every architecture x shape; each ``roofline()`` term is the JAX
   package's times the ratio of the two chips' constants (relative 1e-12:
   one division each).  The analytic model's matmul FLOPs are held against
   ``FlopCounterMode`` on the port's forward: a dense smoke forward's
   ``mm`` FLOPs equal the model's forward less its attention scores
   exactly (the model counts the causal average context S/2, the plain
   attention computes every S x S score, so the scores are left out); a
   smoke MoE layer within rtol 2e-2, because the port rounds each
   expert's capacity up (``ceil``) and builds its dispatch and combine
   one-hots by einsum, which the model leaves out (measured 0.6-1.5%).
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ALIASES, get_config
from repro.configs.base import INPUT_SHAPES
from repro.launch import roofline as j_roofline
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import calibrate, dryrun, mesh, roofline, sharding
from repro_torch.models import build_model

# the JAX package's dry-run record keys (repro.launch.dryrun.run_one)
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "microbatches",
               "lower_s", "compile_s", "memory", "cost", "collectives",
               "model_params", "model_params_active"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes_est"}


@pytest.fixture(scope="module")
def decode_record():
    return dryrun.run_one("stablelm-1.6b", "decode_32k", save=False)


def test_dry_run_record_keeps_the_reference_keys(decode_record):
    rec = decode_record
    assert RECORD_KEYS <= set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    assert {"flops_per_device", "bytes_per_device"} <= set(rec["cost"])
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    mem = rec["memory"]
    assert mem["argument_bytes"] < mem["peak_bytes_est"] < mesh.HBM_BYTES
    assert mem["fits"] and rec["cost"]["flops_per_device"] > 0
    # FSDP'd weights are gathered over the data axis for the decode
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["model_params"] == t_get_config("stablelm-1.6b").param_count()


def test_dry_run_argument_bytes_equal_the_specs_shards(decode_record):
    cfg = t_get_config("stablelm-1.6b")
    shape = INPUT_SHAPES["decode_32k"]
    sizes = {"data": 16, "model": 16}
    sharding.set_axis_sizes(sizes)
    model = build_model(cfg)
    with FakeTensorMode():
        params = model.init(device="cpu")
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
    tokens = {"tokens": torch.empty((shape.global_batch, 1),
                                    dtype=torch.int64, device="meta")}
    want = (sharding.local_bytes(sizes, params,
                                 sharding.param_specs(cfg, params))
            + sharding.local_bytes(sizes, cache, sharding.cache_specs(
                cfg, cache, shape.global_batch, ("data",)))
            + sharding.local_bytes(sizes, tokens, sharding.batch_specs(
                cfg, tokens, shape.global_batch, ("data",))))
    assert decode_record["memory"]["argument_bytes"] == want
    # the cache (2 x 24 layers of 128 x 32768 x 2048 bf16) is 1/256 a rank:
    # rows over data, KV heads over model
    assert decode_record["memory"]["alias_bytes"] == \
        2 * 24 * 128 * 32768 * 2048 * 2 // 256 + 4


@pytest.mark.parametrize("case", ["all-reduce", "all-gather"])
def test_hand_counted_collective(case):
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    with dryrun.fake_world(mesh_shape=(2, 2)) as m, FakeTensorMode():
        x = torch.empty((8, 16))
        w = torch.empty((16, 32))
        counter = dryrun.LocalCounter()
        if case == "all-reduce":
            # a row-parallel matmul: partial sums over model, summed once
            dx = distribute_tensor(x, m, [Replicate(), Shard(1)],
                                   src_data_rank=None)
            dw = distribute_tensor(w, m, [Replicate(), Shard(0)],
                                   src_data_rank=None)
            # the first call fills DTensor's propagation cache (its fake
            # global-shaped ops would count), as the dry run's warm run does
            (dx @ dw).redistribute(m, [Replicate(), Replicate()])
            with counter:
                y = dx @ dw
                assert y.placements == (Replicate(), Partial())
                y = y.redistribute(m, [Replicate(), Replicate()])
            flops, moved = 2 * 8 * 8 * 32, 8 * 32 * 4
        else:
            dx = distribute_tensor(x, m, [Shard(0), Replicate()],
                                   src_data_rank=None)
            dx.redistribute(m, [Replicate(), Replicate()])
            with counter:
                y = dx.redistribute(m, [Replicate(), Replicate()])
            flops, moved = 0, 8 * 16 * 4
        assert y.to_local().shape == y.shape
    want = {c: {"count": 0, "bytes": 0} for c in dryrun.COLLECTIVES}
    want[case] = {"count": 1, "bytes": moved}
    assert counter.collectives == want and counter.flops == flops


def test_calibration_fit_reproduces_the_direct_count():
    cfg = t_get_config("stablelm-1.6b", smoke=True)
    out = calibrate.calibrate("stablelm-1.6b", "decode_32k", cfg=cfg,
                              mesh_shape=(4, 4), save=False)
    assert out["fit_matches_direct"], (out["ops"], out["direct"])
    assert out["direct"]["all-gather"]["count"] > 0
    assert out["ops"]["all-gather"]["per_layer_count"] > 0


def test_calibration_with_reps_matches_reference():
    from repro.launch.calibrate import with_reps as j_with_reps
    for arch in ALIASES:
        for r in (1, 2):
            got = calibrate.with_reps(t_get_config(arch), r)
            want = j_with_reps(get_config(arch), r)
            assert got.layer_program == want.layer_program
            assert (got.n_layers, got.n_encoder_layers) == \
                (want.n_layers, want.n_encoder_layers)


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_analytic_model_matches_reference(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert roofline.flops_model(tcfg, shape) == \
            j_roofline.flops_model(cfg, shape), name
        assert roofline.bytes_model(tcfg, shape) == \
            j_roofline.bytes_model(cfg, shape), name


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_roofline_terms_scale_by_the_chips_constants(arch):
    from repro.launch import mesh as j_mesh
    ratio = {"compute_s": j_mesh.PEAK_FLOPS_BF16 / mesh.PEAK_FLOPS_BF16,
             "memory_s": j_mesh.HBM_BW / mesh.HBM_BW,
             "collective_s": j_mesh.ICI_BW / mesh.LINK_BW}
    rec = {"cost": {}}              # no record read from disk
    for name in INPUT_SHAPES:
        for replicated in (False, True):
            want = j_roofline.roofline(arch, name, rec=rec, coll_bytes=3e9,
                                       replicated_weights=replicated)
            got = roofline.roofline(arch, name, rec=rec, coll_bytes=3e9,
                                    replicated_weights=replicated)
            for term, r in ratio.items():
                assert got[term] == pytest.approx(want[term] * r,
                                                  rel=1e-12), (name, term)
            assert got["flops_total"] == want["flops_total"]


def test_h100_constants_are_one_source():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.HBM_BYTES_PER_S == mesh.HBM_BW
    assert chip_smoke.PEAK_OPS["bfloat16"] == mesh.PEAK_FLOPS_BF16
    assert chip_smoke.PEAK_OPS["float32"] == mesh.PEAK_FLOPS_F32
    assert chip_smoke.PEAK_OPS["tf32"] == mesh.PEAK_FLOPS_TF32
    assert "tensor" in roofline.SUGGESTIONS["compute_s"]
    assert "MXU" not in roofline.SUGGESTIONS["compute_s"]


def test_dense_matmul_flops_match_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(t_get_config("stablelm-1.6b", smoke=True),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(device="cpu")
    b, s = 4, 64
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.train_logits(params, {"tokens": torch.zeros((b, s),
                                                          dtype=torch.long)})
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    fwd = roofline.flops_model(cfg, InputShape("t", s, b, "prefill"))["fwd"]
    scores = cfg.n_layers * 2 * 2 * b * s * cfg.n_heads * cfg.d_head * s / 2
    assert counts["aten.mm"] == fwd - scores


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_moe_flops_match_flop_counter(arch):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.layers import moe_apply
    cfg = t_get_config(arch, smoke=True)
    params = build_model(cfg).init(device="cpu")
    moe = next(blk["moe"] for layers in params["stack"]["group"].values()
               for blk in layers if "moe" in blk)
    for b, s in ((4, 64), (2, 2048)):
        x = torch.randn((b, s, cfg.d_model), dtype=torch.float32)
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            moe_apply(moe, cfg, x.to(params["embed"].dtype))
        assert fc.get_total_flops() == pytest.approx(
            roofline._moe_flops(cfg, b * s), rel=2e-2)
