"""Checkpoints in the reference's file format (``train/checkpoint.py``).

``<dir>/step_<n>/arrays.npz`` holds every parameter under ``p/<path>`` and
every optimizer-state leaf under ``o/<path>`` (paths joined with ``/``,
as the reference's tree paths), beside ``meta.json`` (``{"step": n,
"format": 1, ...extra}``), so either package restores the other's files.

* **Atomic**: written to ``<dir>/tmp.<step>`` and renamed with
  ``os.replace``; a save that died before its rename is invisible.
* **keep-k GC** and **latest-valid discovery** (:func:`latest_step`).
* **Async**: the arrays are copied to the host before the optional
  writer thread starts, since the next step updates the tensors in place.
* **Elastic resharding**: the file holds whole arrays whatever the mesh.
  :func:`save` with ``param_sh``/``opt_sh`` gathers each leaf from the
  ranks' blocks (every rank calls it) and rank 0 writes; :func:`restore`
  with them cuts each array to this rank's block of the new mesh, which
  may have another shape than the one that saved.

Tensors are stored as numpy arrays (float32, int32 and other types numpy
has; bfloat16 has no numpy type and raises).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.lm import tree_leaves

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree) -> Dict[str, Any]:
    """``{path: leaf}``, paths as the reference's (keys joined by ``/``)."""
    return {path.lstrip("/"): leaf for path, leaf in tree_leaves(tree)}


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy type; cast the "
                            "tree to float32 before saving")
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def _whole(tree, shardings, prefix: str, write: bool) -> Dict[str, Any]:
    """``{prefix/path: numpy}`` of ``tree``'s leaves, each gathered whole
    first when ``shardings`` places them; empty where ``write`` is false
    (those ranks only take part in the gathers)."""
    shs = (_flatten(shardings) if shardings is not None else {})
    out = {}
    for k, v in _flatten(tree).items():
        if k in shs:
            v = shs[k].gather(v)
        if write:
            out[f"{prefix}/{k}"] = _host(v)
    return out


def save(ckpt_dir: str, step: int, params, opt_state, *,
         extra: Optional[Dict[str, Any]] = None, keep: int = 3,
         async_save: bool = False, param_sh=None,
         opt_sh=None) -> Optional[threading.Thread]:
    """Atomically write ``<ckpt_dir>/step_<step>``; keep the ``keep``
    newest.  With ``async_save`` the write runs on a thread, returned.

    ``param_sh``/``opt_sh`` (``NamedSharding`` trees): the trees are this
    rank's blocks; every rank of the mesh calls ``save``, the leaves are
    gathered whole, and rank 0 writes.  Unless ``async_save``, every rank
    returns once the step is committed."""
    sh = param_sh if param_sh is not None else opt_sh
    mesh = None
    if sh is not None:
        mesh = next(leaf for _, leaf in tree_leaves(sh)).mesh
    write = mesh is None or mesh.rank == 0
    host = _whole(params, param_sh, "p", write)
    host.update(_whole(opt_state, opt_sh, "o", write))
    if not write:
        if not async_save:
            mesh.barrier()
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = {"step": int(step), "format": 1}
    meta.update(extra or {})

    def _write():
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if mesh is not None:
        mesh.barrier()
    return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    """Every committed step (a ``step_<n>`` directory with ``meta.json``)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, params_like, opt_like, *,
            device=None, param_sh=None,
            opt_sh=None) -> Tuple[Any, Any, Dict[str, Any]]:
    """``(params, opt_state, meta)`` of ``step``, in the structure of
    ``params_like``/``opt_like`` (trees of tensors), each leaf on
    ``device`` or, by default, on its template leaf's device.

    ``param_sh``/``opt_sh`` (``NamedSharding`` trees of the mesh to
    restore onto): each leaf is this rank's block of the saved array,
    whatever mesh saved it (the reference's elastic resharding)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        def rebuild(prefix, like, sh):
            shs = _flatten(sh) if sh is not None else {}

            def one(key, leaf):
                t = torch.from_numpy(np.array(arrays[f"{prefix}/{key}"]))
                if key in shs:
                    t = shs[key].shard(t)
                return t.to(device if device is not None else leaf.device)
            return _unflatten(like, {k: one(k, v)
                                     for k, v in _flatten(like).items()})
        params = rebuild("p", params_like, param_sh)
        opt_state = rebuild("o", opt_like, opt_sh)
    return params, opt_state, meta


def _unflatten(like, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    return flat[prefix.rstrip("/")]


def restore_latest(ckpt_dir: str, params_like, opt_like, **kw):
    """:func:`restore` of the newest committed step, or ``None``."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, params_like, opt_like, **kw)
