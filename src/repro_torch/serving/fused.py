"""The scheduler's fused decode block: up to ``sync_n`` greedy decode steps
of a certified batch with no host round trip, the port's counterpart of
the JAX package's jitted ``lax.while_loop`` (``repro.serving.scheduler``,
``_build_fused``).

Torch has no on-device while loop, so the block always runs ``sync_n``
steps and gates each on the device by ``go = (i < n_cap) & active.any()``:
a step after the reference's loop would have ended commits nothing, and
``steps`` counts the gated steps.  A step gathers each row's mask from the
device grammar table, selects by the masked-argmax kernel (#2), advances
the table state, feeds the token (a pad for rows that stopped) through one
decode forward (#1 or #1b for attention) and poisons the logits rows the
``decode_nan`` plan names.  At the end ``len = snap_len + n_fed``: every
forward advanced every row's ``len``, and only the fed tokens are real.

On the card the block is recorded once as a CUDA graph over static input
and output buffers and replayed every block: one dispatch a block.  The
host stages its inputs in one upload and reads the tokens, raw argmaxes,
states, fed counts, fault flags and step count back in one copy, the
block's one host sync.  On the CPU the same body runs eagerly.  A replay
calls no launch wrapper, so each replay credits every wrapper with the
launches it counted while the block was recorded.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.decode_attention import kernel as attn_kernel
from repro_torch.kernels.mamba_scan import kernel as mamba_kernel
from repro_torch.kernels.masked_sample import kernel as mask_kernel
from repro_torch.kernels.masked_sample.ops import masked_argmax
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel


class GraphCaptureError(RuntimeError):
    """The fused block could not be recorded as a CUDA graph."""


def _wrappers():
    """Every kernel launch wrapper, whose ``launches`` a replay credits."""
    return (attn_kernel.decode_attention_cuda,
            attn_kernel.decode_attention_split_cuda,
            mask_kernel.masked_argmax_packed, mask_kernel.masked_argmax_bytes,
            mamba_kernel.mamba_scan_cuda, ssd_kernel.ssd_scan_cuda)


class RecordedGraph:
    """``fn`` recorded once as a CUDA graph on ``device``, replayed with
    launch credit.  ``fn`` runs once eagerly on a side stream first (the
    kernels allocate their per-stream scratch there, and its effects must
    be the ones a replay repeats), then is recorded on that stream;
    ``out`` is what the recorded call returned, rewritten by every replay.
    The wrappers' counts of the recording are taken back (recording
    launches nothing) and credited to each replay."""

    def __init__(self, fn, device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        wrappers = _wrappers()
        before = [w.launches for w in wrappers]
        try:
            with torch.cuda.graph(self.graph, stream=side):
                self.out = fn()
        except Exception as e:
            raise GraphCaptureError(f"recording failed: {e!r}") from e
        finally:
            counted = [w.launches - b for w, b in zip(wrappers, before)]
            for w, b in zip(wrappers, before):
                w.launches = b
        self.recorded = {w: c for w, c in zip(wrappers, counted) if c}
        key = (device.index, side.cuda_stream)
        # the graph holds the scratch's addresses: keep it alive even if
        # an engine reset drops it from the wrappers' tables
        self._keep = (side, mask_kernel._SCRATCH.get(key),
                      attn_kernel._COUNTERS.get(key))

    def replay(self) -> None:
        self.graph.replay()
        for w, c in self.recorded.items():
            w.launches += c


@dataclasses.dataclass
class BlockOutput:
    logits: torch.Tensor    # (B, Vpad) float32: each row's next logits
    lens: torch.Tensor      # (B,) int32: snap_len + n_fed
    toks: np.ndarray        # (B, N) committed tokens, -1 where none
    raws: np.ndarray        # (B, N) raw argmaxes of the committed steps
    state: np.ndarray       # (B,) table state after the block
    n_fed: np.ndarray       # (B,) tokens fed to the forward
    fault: np.ndarray       # (B,) non-finite logits met by an active row
    steps: int              # steps the reference's loop would have run


class FusedBlock:
    """Static buffers, the block body and (on the card) its CUDA graph for
    one scheduler: ``stage`` the host inputs, then ``run``."""

    def __init__(self, engine, capacity: int, sync_n: int):
        self.eng = engine
        self.cap, self.n = capacity, sync_n
        self.v = engine._v
        self.pad = engine.tok.pad_id
        self.dev = engine.device
        cap, n, dev = capacity, sync_n, self.dev
        # host inputs, one int32 upload: state, active, rem, eos (cap
        # each), the decode_nan plan (cap * n) and n_cap
        self._host_in = np.zeros(4 * cap + cap * n + 1, np.int32)
        self.s_in = torch.zeros(self._host_in.shape, dtype=torch.int32,
                                device=dev)
        self.s_len = torch.zeros((cap,), dtype=torch.int32, device=dev)
        self.s_logits = torch.zeros((cap, engine.model.padded_vocab),
                                    dtype=torch.float32, device=dev)
        # outputs: everything the host reads in one int32 copy, and what
        # stays on the card
        self.o_pack = torch.zeros((2 * cap * n + 3 * cap + 1,),
                                  dtype=torch.int32, device=dev)
        self.o_logits = torch.zeros_like(self.s_logits)
        self.o_len = torch.zeros_like(self.s_len)
        self.graph: Optional[RecordedGraph] = None
        self.n_blocks = 0          # blocks run
        self.n_replays = 0         # graph replays
        self.n_records = 0         # graph recordings
        self.record_s = 0.0        # seconds spent recording

    def drop_graph(self) -> None:
        """Forget the recorded graph (its cache addresses are gone after an
        engine reset); the next block records again."""
        self.graph = None

    # -- inputs -----------------------------------------------------------------

    def stage(self, state, active, rem, eos, nan_plan, n_cap: int) -> None:
        """Fill the host staging buffer for the next block."""
        cap, n = self.cap, self.n
        h = self._host_in
        h[0:cap] = state
        h[cap:2 * cap] = active
        h[2 * cap:3 * cap] = rem
        h[3 * cap:4 * cap] = eos
        h[4 * cap:4 * cap + cap * n] = np.asarray(nan_plan,
                                                  bool).reshape(-1)
        h[-1] = n_cap

    # -- the body ---------------------------------------------------------------

    def _body(self, cache, mask_tab: torch.Tensor,
              trans_tab: torch.Tensor) -> None:
        """``n`` gated steps from the static inputs into the static
        outputs; the cache's leaves are written in place."""
        eng, cap, n, v = self.eng, self.cap, self.n, self.v
        dev = self.dev
        s_in = self.s_in
        state = s_in[0:cap]
        active = s_in[cap:2 * cap] != 0
        rem = s_in[2 * cap:3 * cap]
        eos = s_in[3 * cap:4 * cap]
        nan_plan = (s_in[4 * cap:4 * cap + cap * n] != 0).reshape(cap, n)
        n_cap = s_in[-1]
        snap_len = self.s_len
        view = dict(cache, len=snap_len)
        lg = out_lg = self.s_logits
        toks = torch.full((cap, n), -1, dtype=torch.int32, device=dev)
        raws = torch.full((cap, n), -1, dtype=torch.int32, device=dev)
        n_fed = torch.zeros((cap,), dtype=torch.int32, device=dev)
        fault = torch.zeros((cap,), dtype=torch.bool, device=dev)
        steps = torch.zeros((1,), dtype=torch.int32, device=dev)
        for i in range(n):
            go = (n_cap > i) & active.any()
            act = active & go
            lv = lg[:, :v]
            finite = torch.isfinite(lv).all(dim=-1)
            fault = fault | (act & ~finite)
            commit = act & finite
            sid = torch.clamp(state, min=0).long()
            sel, _ = masked_argmax(lv, mask_tab[sid])
            raw = torch.argmax(lv, dim=-1).to(torch.int32)
            eos_hit = commit & (sel == eos)
            adv = commit & ~eos_hit
            rem = torch.where(adv, rem - 1, rem)
            fed = adv & (rem > 0)
            nxt = trans_tab[sid, torch.clamp(sel, min=0).long()]
            state = torch.where(adv, nxt, state)
            toks[:, i] = torch.where(commit, sel, -1)
            raws[:, i] = torch.where(commit, raw, -1)
            feed = torch.where(fed, sel, self.pad).to(torch.int64)[:, None]
            new_lg, view = eng._decode(eng.params, view, feed)
            new_lg = new_lg[:, -1].to(torch.float32)
            new_lg = torch.where(nan_plan[:, i:i + 1], float("nan"), new_lg)
            out_lg = torch.where(fed[:, None], new_lg, out_lg)
            n_fed = n_fed + fed.to(torch.int32)
            active = fed & (nxt >= 0)
            steps = steps + go.to(torch.int32)
            lg = new_lg
        self.o_logits.copy_(out_lg)
        self.o_len.copy_(snap_len + n_fed)
        self.o_pack.copy_(torch.cat([toks.reshape(-1), raws.reshape(-1),
                                     state, n_fed, fault.to(torch.int32),
                                     steps]))

    # -- running ----------------------------------------------------------------

    def launch(self, cache, dts) -> None:
        """Run the block on the staged inputs: a graph replay on the card
        (recording it first if needed), the body itself on the CPU."""
        if self.dev.type != "cuda":
            self._body(cache, dts.mask_dev, dts.trans_dev)
            return
        if self.graph is None:
            t0 = time.perf_counter()
            self.graph = RecordedGraph(
                lambda: self._body(cache, dts.mask_dev, dts.trans_dev),
                self.dev)
            self.n_records += 1
            self.record_s += time.perf_counter() - t0
        self._replay()

    def _replay(self) -> None:
        self.graph.replay()
        self.n_replays += 1

    def replay_matches_eager(self, cache, dts) -> bool:
        """A diagnostic run of the staged block in place of ``launch`` on
        the card: once eagerly, then by replay (which rewrites what the
        eager run wrote); True when the outputs and every cache leaf are
        bitwise equal after both.  The graph must be recorded."""
        leaves = [self.o_pack, self.o_logits, self.o_len] + [
            x for part in ("head", "tail") for blk in cache[part]
            for x in blk.values()] + [
            x for blk in cache["group"].values() for x in blk.values()]
        self._body(cache, dts.mask_dev, dts.trans_dev)
        want = [x.clone() for x in leaves]
        self._replay()
        return all(torch.equal(a, b) for a, b in zip(want, leaves))

    def readback(self) -> np.ndarray:
        """The block's one device-to-host copy."""
        return self.o_pack.cpu().numpy()

    def run(self, cache, logits: torch.Tensor, dts) -> BlockOutput:
        """Upload the staged inputs, run the block from ``cache`` (its
        ``len`` and leaves) and ``logits``, and read the results back."""
        self.s_in.copy_(torch.from_numpy(self._host_in), non_blocking=True)
        self.s_len.copy_(cache["len"])
        self.s_logits.copy_(logits)
        self.launch(cache, dts)
        self.n_blocks += 1
        pack = self.readback()
        cap, n = self.cap, self.n
        o = 2 * cap * n
        return BlockOutput(
            logits=self.o_logits.clone(), lens=self.o_len.clone(),
            toks=pack[:cap * n].reshape(cap, n),
            raws=pack[cap * n:o].reshape(cap, n),
            state=pack[o:o + cap], n_fed=pack[o + cap:o + 2 * cap],
            fault=pack[o + 2 * cap:o + 3 * cap] != 0, steps=int(pack[-1]))
