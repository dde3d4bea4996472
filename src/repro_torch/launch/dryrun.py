"""Multi-pod dry run of the port, the counterpart of ``repro.launch.dryrun``.

A CPU tool: it touches no card and allocates no tensor.  For an
(architecture x input shape) it starts the ``fake`` process group at 256
(or 512) ranks, builds the production mesh, and runs ONE step of the
workload eagerly on this rank's shards under ``FakeTensorMode``: the
params, AdamW state, inputs and cache are fake DTensors sharded by
``launch.sharding``'s rules, every collective returns at once and moves
nothing.  The record keeps the JAX package's keys:

  - ``memory``: argument bytes a rank (its shards of params, optimizer
    state, inputs and cache), output bytes, the peak ``MemTracker`` sees
    during the step, the temporaries above the arguments, and whether the
    peak fits one card's 80 GB (NVIDIA H100 SXM data sheet);
  - ``cost.flops_per_device``: the FLOPs ``torch.utils.flop_counter``
    counts on this rank's local ops;
  - ``collectives``: count and bytes a rank of each collective DTensor
    issues, under the five names of the JAX package's ``parse_collectives``
    (the bytes are each functional collective's result, as the reference
    reads each HLO collective's result shape);
  - ``model_params`` and ``model_params_active``.

An eager step runs every layer, so the counts need no trip-count fit (see
``calibrate``).  Shapes:

  train_4k     train step   (B=256, S=4096), microbatched
  prefill_32k  prefill      (B=32,  S=32768)
  decode_32k   decode step  (B=128, one token, 32k cache)
  long_500k    decode step  (B=1,   one token, 512k cache) -- sub-quadratic
               archs only

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod  # 2x16x16

Records go to artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ALIASES, get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.launch import sharding
from repro_torch.launch.mesh import (HBM_BYTES, data_axes,
                                     make_production_mesh, start_fake_world)
from repro_torch.models import act_sharding, build_model
from repro_torch.models.convert import tree_items, tree_map
from repro_torch.models.layers import DTYPES
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import loss_and_grads, make_loss_fn

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

# long_500k applicability: sub-quadratic context handling only
LONG_OK = {"llava-next-mistral-7b", "gemma3-27b", "zamba2-1.2b",
           "falcon-mamba-7b"}

# gradient-accumulation defaults for train_4k (global batch 256 preserved;
# microbatching bounds per-device activation residency ~ 1/n)
TRAIN_MICROBATCHES = {
    "llava-next-mistral-7b": 8,
    "yi-34b": 8,
    "whisper-tiny": 1,
    "gemma3-27b": 8,
    "zamba2-1.2b": 8,
    "falcon-mamba-7b": 4,
    "minicpm-2b": 2,
    "stablelm-1.6b": 2,
    "arctic-480b": 8,
    "deepseek-v3-671b": 8,
}


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.arch_id not in LONG_OK:
        return False, ("full-attention arch: long_500k skipped (its "
                       "context is quadratic)")
    return True, ""


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(map(str, mesh_shape))
    return "pod2x16x16" if multi_pod else "16x16"


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Stand-ins for every model input of this workload, made as fake
    tensors when called under ``FakeTensorMode`` (meta tensors otherwise)."""
    dev = None if _fake_mode_active() else "meta"
    dt = DTYPES[cfg.dtype]
    b, s = shape.global_batch, shape.seq_len

    def ids(*sh):
        return torch.empty(sh, dtype=torch.int64, device=dev)

    def emb(*sh):
        return torch.empty(sh, dtype=dt, device=dev)

    if shape.kind == "decode":
        # ONE new token against a seq_len cache
        return {"tokens": ids(b, 1)}
    n = s + 1 if shape.kind == "train" else s
    out: Dict[str, Any] = {"tokens": ids(b, n)}
    if cfg.family == "vlm":
        p = cfg.n_prefix_tokens
        out["tokens"] = ids(b, n - p)
        out["prefix"] = emb(b, p, cfg.d_model)
    if cfg.is_encoder_decoder:
        out["frames"] = emb(b, cfg.encoder_seq_len, cfg.d_model)
    return out


def _fake_mode_active() -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


# ---------------------------------------------------------------------------
# collectives and FLOPs on the local ops
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_ops() -> Dict[Any, str]:
    f = torch.ops._c10d_functional
    c = torch.ops.c10d
    return {
        f.all_gather_into_tensor: "all-gather",
        f.all_gather_into_tensor_coalesced: "all-gather",
        c._allgather_base_: "all-gather",
        c.allgather_: "all-gather",
        f.all_reduce: "all-reduce",
        f.all_reduce_coalesced: "all-reduce",
        c.allreduce_: "all-reduce",
        f.reduce_scatter_tensor: "reduce-scatter",
        f.reduce_scatter_tensor_coalesced: "reduce-scatter",
        c._reduce_scatter_base_: "reduce-scatter",
        f.all_to_all_single: "all-to-all",
        c.alltoall_base_: "all-to-all",
        c.alltoall_: "all-to-all",
        f.broadcast: "collective-permute",
        c.broadcast_: "collective-permute",
        c.scatter_: "collective-permute",
        c.send: "collective-permute",
        c.recv_: "collective-permute",
    }


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size()
               for t in (out if isinstance(out, (list, tuple)) else [out])
               if isinstance(t, torch.Tensor))


# ops that move no bytes through memory: factories of uninitialized memory
# and metadata
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.detach,
               torch.ops.aten.alias, torch.ops.aten.lift_fresh}


class LocalCounter(TorchDispatchMode):
    """Counts what one rank runs: the FLOPs of its local ops (the
    ``flop_counter`` registry's formulas) and each collective DTensor
    issues, with the bytes of its result.  DTensor ops pass through
    (``NotImplemented``) so that DTensor lowers them to the local ops and
    collectives this mode then sees."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._ops = _collective_ops()
        self.flops = 0
        self.bytes = 0          # operands read and results written
        self.collectives = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        name = self._ops.get(packet)
        if name is not None:
            self.collectives[name]["count"] += 1
            self.collectives[name]["bytes"] += _nbytes(out)
            return out
        if packet in self._flops.flop_registry:
            self.flops += self._flops.flop_registry[packet](
                *args, **kwargs, out_val=out)
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        self.bytes += _nbytes(list(args)) + _nbytes(out)
        return out


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def _local_chunks(x, n: int):
    """A batch DTensor split into ``n`` microbatches on each rank's own rows
    (no collective): rank r's microbatch i is the i-th slice of its
    shard, with the shard's placements."""
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(c, x.device_mesh, x.placements,
                               run_check=False)
            for c in x.to_local().chunk(n)]


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               opt_cfg: Optional[opt.AdamWConfig] = None,
               microbatches: int = 1, serve_fsdp: bool = True,
               shard_logits_out: bool = False):
    """(step, args, specs): ``step(*args)`` runs the workload once on this
    rank's shards; ``args`` are fake DTensors sharded by ``specs`` (call
    under ``FakeTensorMode`` with the fake world started).  Train steps
    accumulate ``microbatches`` gradients in float32; a decode step with
    ``shard_logits_out`` leaves its logits vocab-sharded (the grammar
    mask applies per shard)."""
    from torch.distributed.tensor.experimental import implicit_replication
    model = build_model(cfg)
    sharding.set_axis_sizes(mesh)
    dp = data_axes(mesh)
    params = model.init(device="cpu")
    pspec = sharding.param_specs(
        cfg, params, fsdp=True if shape.kind == "train" else serve_fsdp)
    inputs = input_specs(cfg, shape)
    bspec = sharding.batch_specs(cfg, inputs, shape.global_batch, dp)
    params = sharding.shard_tree(mesh, params, pspec)
    inputs = sharding.shard_tree(mesh, inputs, bspec)

    if shape.kind == "train":
        ocfg = opt_cfg or opt.AdamWConfig()
        ospec = sharding.opt_state_specs(pspec)
        state = opt.init_state(params, ocfg)
        loss_fn = make_loss_fn(model)

        def train_step(params, state, batch):
            with implicit_replication():
                if microbatches == 1:
                    params, loss, _, grads = loss_and_grads(loss_fn, params,
                                                            batch)
                else:
                    # gradient accumulation: the same global batch at 1/n
                    # of the activations; grads summed in float32
                    parts = {k: _local_chunks(v, microbatches)
                             for k, v in batch.items()}
                    grads, grads_flat, loss = None, {}, 0.0
                    for i in range(microbatches):
                        params, l, _, g = loss_and_grads(
                            loss_fn, params, {k: v[i]
                                              for k, v in parts.items()})
                        flat = {path: x.to(torch.float32)
                                for path, x in tree_items(g)}
                        grads = tree_map(
                            lambda x, path: flat[path] if grads is None
                            else grads_flat[path] + flat[path], g,
                            with_path=True)
                        grads_flat = dict(tree_items(grads))
                        loss = loss + l.detach() / microbatches
                    grads = tree_map(lambda x: x / microbatches, grads)
                return opt.apply_updates(params, grads, state, ocfg)[:2] \
                    + (loss,)

        return train_step, (params, state, inputs), (pspec, ospec, bspec)

    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="cpu")
    cspec = sharding.cache_specs(cfg, cache, shape.global_batch, dp)
    cache = sharding.shard_tree(mesh, cache, cspec)

    if shape.kind == "prefill":
        def prefill_step(params, inputs, cache):
            with torch.no_grad(), implicit_replication():
                return model.prefill(params, inputs, cache)
        return prefill_step, (params, inputs, cache), (pspec, bspec, cspec)

    def serve_step(params, cache, tokens):
        with torch.no_grad(), implicit_replication():
            logits, cache = model.decode_step(params, cache, tokens)
            if not shard_logits_out:
                logits = act_sharding.unshard(logits, -1)
            return logits, cache
    return serve_step, (params, cache, inputs["tokens"]), \
        (pspec, cspec, bspec["tokens"])


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(multi_pod: bool = False, mesh_shape=None):
    """The fake process group of the production mesh's rank count (or of a
    (data, model) ``mesh_shape``), its mesh registered for the activation
    constraints, all torn down after."""
    import torch.distributed as dist
    if mesh_shape is None:
        start_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        from torch.distributed.device_mesh import init_device_mesh
        start_fake_world(mesh_shape[0] * mesh_shape[1])
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
    act_sharding.register_mesh(mesh)
    act_sharding.configure(data_axes(mesh), "model")
    try:
        yield mesh
    finally:
        act_sharding.register_mesh(None)
        act_sharding.configure(None)
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for _, t in tree_items(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            total += t.numel() * t.element_size()
    return total


def _local_tensors(tree):
    from torch.distributed.tensor import DTensor
    return [t.to_local() if isinstance(t, DTensor) else t
            for _, t in tree_items(tree) if isinstance(t, torch.Tensor)]


def local_mem_tracker():
    """A ``MemTracker`` of this rank's storages.  As a dispatch mode it
    would see a DTensor op first and count its output's global bytes; this
    one lets DTensor lower the op (``NotImplemented``) and counts the local
    tensors and collective buffers that come out."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def measure_step(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under a local ``MemTracker`` and a
    :class:`LocalCounter`; memory, FLOPs and collectives of this rank."""
    arg_bytes = _local_bytes(list(args))
    # a first run fills DTensor's sharding-propagation cache: propagating
    # an op makes global-shaped fake tensors, which the trackers would
    # take for this rank's memory and work
    t0 = time.perf_counter()
    fn(*args)
    warm_s = time.perf_counter() - t0
    tracker = local_mem_tracker()
    tracker.track_external(*_local_tensors(list(args)))
    counter = LocalCounter()
    t0 = time.perf_counter()
    with tracker, counter:
        out = fn(*args)
    run_s = time.perf_counter() - t0
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    out_bytes = _local_bytes(list(out))
    # a decode or prefill step writes its cache in place (the reference
    # donates it); a train step makes new params and moments
    alias = _local_bytes(args[1]) if fn.__name__ == "serve_step" else \
        _local_bytes(args[2]) if fn.__name__ == "prefill_step" else 0
    return {
        # the first run stands for the reference's compile: it fills
        # DTensor's sharding-propagation cache
        "compile_s": warm_s, "run_s": run_s,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(0, peak - arg_bytes),
                   "alias_bytes": alias, "peak_bytes_est": peak,
                   "fits": peak <= HBM_BYTES},
        "cost": {"flops_per_device": float(counter.flops),
                 "bytes_per_device": float(counter.bytes)},
        "collectives": counter.collectives,
    }


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            save: bool = True, opt_cfg=None, microbatches: int = 1,
            cfg_override: Optional[ModelConfig] = None,
            serve_fsdp: bool = True, shard_logits_out: bool = False,
            variant: str = "", mesh_shape=None) -> Dict[str, Any]:
    """One (arch, shape) on the fake production mesh (or a (data, model)
    ``mesh_shape``) -> its record (saved under ``ART`` unless ``save`` is
    false)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": cfg.arch_id, "shape": shape_name,
        "mesh": mesh_name(multi_pod, mesh_shape),
        "n_devices": (mesh_shape[0] * mesh_shape[1] if mesh_shape
                      else 512 if multi_pod else 256),
        "tool": "CPU dry run: fake process group, FakeTensorMode; no card",
    }
    if not ok:
        rec["skipped"] = why
        if save:
            _save(rec)
        return rec
    rec["microbatches"] = microbatches
    if variant:
        rec["variant"] = variant
    with fake_world(multi_pod, mesh_shape) as mesh, FakeTensorMode(
            allow_non_fake_inputs=True):
        t0 = time.perf_counter()
        fn, args, specs = build_step(cfg, shape, mesh, opt_cfg,
                                     microbatches=microbatches,
                                     serve_fsdp=serve_fsdp,
                                     shard_logits_out=shard_logits_out)
        rec["lower_s"] = time.perf_counter() - t0     # the step's build
        rec["argument_bytes_from_specs"] = sum(
            sharding.local_bytes(mesh, a, s) for a, s in zip(args, specs))
        rec.update(measure_step(fn, args))
    rec["model_params"] = cfg.param_count()
    rec["model_params_active"] = cfg.active_param_count()
    if save:
        _save(rec)
    return rec


def _save(rec: Dict[str, Any]) -> None:
    ART.mkdir(parents=True, exist_ok=True)
    suffix = f"_{rec['variant']}" if rec.get("variant") else ""
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"
    (ART / name.replace("/", "_")).write_text(json.dumps(rec, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id (dashed), default: all")
    ap.add_argument("--shape", default=None,
                    help="input shape name, default: all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ALIASES.keys())
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES.keys())
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    print("[dryrun] a CPU tool: the fake process group and FakeTensorMode; "
          "no card is touched, nothing is allocated", flush=True)
    n_fail = 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                tag = f"{a} x {s} x {mesh_name(mp)}"
                try:
                    t0 = time.perf_counter()
                    mb = TRAIN_MICROBATCHES.get(a, 1) if s == "train_4k" \
                        else 1
                    rec = run_one(a, s, multi_pod=mp, microbatches=mb)
                    if "skipped" in rec:
                        print(f"[skip] {tag}: {rec['skipped']}", flush=True)
                        continue
                    mem = rec["memory"]
                    coll = sum(v["bytes"]
                               for v in rec["collectives"].values())
                    print(f"[ok]   {tag}: "
                          f"flops/dev={rec['cost']['flops_per_device']:.3e} "
                          f"arg={mem['argument_bytes'] / 2**30:.2f}GiB "
                          f"peak={mem['peak_bytes_est'] / 2**30:.2f}GiB "
                          f"coll={coll / 2**20:.1f}MiB "
                          f"({time.perf_counter() - t0:.0f}s)", flush=True)
                except Exception as e:  # noqa: BLE001 -- report, go on
                    n_fail += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                          flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} combinations failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
