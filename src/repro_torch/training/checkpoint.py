"""Checkpoints in the JAX package's on-disk format
(``repro.training.checkpoint``): ``params.npz`` (and ``opt_state.npz``)
keyed by the flattened tree path -- dict keys, ``[i]`` for list indices,
joined by ``/`` -- in ``repro``'s layout (the group's layers stacked on a
leading ``reps`` axis), and ``meta.json``.  A checkpoint written by either
package loads into the other."""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        reference_layout, state_from_numpy,
                                        state_to_numpy, tree_items, tree_map)


def _key_str(k) -> str:
    return f"[{k}]" if isinstance(k, int) else str(k)


def _key(path) -> str:
    return "/".join(_key_str(k) for k in path)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_key(path): np.asarray(leaf) for path, leaf in tree_items(tree)}


def save(path, params, opt_state=None, meta: Dict[str, Any] = None) -> None:
    """Write the port's ``params`` (and an AdamW ``opt_state``) to the
    directory ``path``."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "params.npz", **_flatten(params_to_numpy(params)))
    if opt_state is not None:
        np.savez(path / "opt_state.npz", **_flatten(state_to_numpy(opt_state)))
    (path / "meta.json").write_text(json.dumps(meta or {}, default=str))


def _fill(shapes, npz):
    """The arrays of ``npz`` at the template's keys; a vocab that grew since
    the save (embed / lm_head padded to a multiple of 256) is zero-padded,
    which is exact since pad logits are masked."""
    def one(shape, path):
        key = _key(path)
        arr = npz[key]
        if arr.shape != shape:
            if len(arr.shape) != len(shape) or any(
                    a > b for a, b in zip(arr.shape, shape)):
                raise ValueError(f"checkpoint shape mismatch at {key}: "
                                 f"{arr.shape} vs {shape}")
            arr = np.pad(arr, [(0, b - a) for a, b in zip(arr.shape, shape)])
        return arr
    return tree_map(one, shapes, with_path=True)


def _reference_shapes(model) -> Dict[str, Any]:
    """The shapes of ``model``'s params in ``repro``'s layout, from an init
    on the meta device (no memory, no draws)."""
    meta = model.init(torch.Generator(), device="meta")
    return reference_layout(meta, lambda t: tuple(t.shape),
                            lambda xs: (len(xs),) + xs[0])


def load(path, model, device="cuda", with_opt: bool = False
         ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], Dict[str, Any]]:
    """(params, AdamW state or None, meta) for ``model`` on ``device``
    from the directory ``path``; the state only ``with_opt`` and if one was
    saved, its moments in float32."""
    path = pathlib.Path(path)
    dev = resolve_device(device)
    shapes = _reference_shapes(model)
    params = params_from_numpy(_fill(shapes, np.load(path / "params.npz")),
                               model.cfg, dev)
    meta = json.loads((path / "meta.json").read_text())
    opt = None
    if with_opt and (path / "opt_state.npz").exists():
        tree = _fill({"m": shapes, "v": shapes, "step": ()},
                     np.load(path / "opt_state.npz"))
        opt = state_from_numpy(tree, model.cfg, dev)
    return params, opt, meta
