"""Checkpoint save/restore as plain ``.npz`` files (the reference uses
torch.save dicts every 100 epochs with resume-by-argv, main_pn.py:258-277 and
66-73).

A checkpoint directory holds one ``ckpt_<step>.npz`` per saved step, the
newest ``MAX_TO_KEEP`` of them.  Each file stores the flattened pytrees keyed
by path (``params/params/delta_net/Dense_0/kernel``, ``opt_state/...``,
``ema_params/...``) beside ``step`` and ``training_loss``.  Restoring
unflattens into a template with the same structure, so any pytree of arrays
(dicts, tuples, optax states) round-trips bit for bit.
"""

from __future__ import annotations

import os
import re
from typing import Any, NamedTuple, Optional

import jax
import numpy as np

__all__ = ["RestoredCheckpoint", "save_checkpoint", "restore_checkpoint",
           "load_checkpoint_file", "latest_step", "MAX_TO_KEEP"]

MAX_TO_KEEP = 3
_FILE_RE = re.compile(r"^ckpt_(\d+)\.npz$")


class RestoredCheckpoint(NamedTuple):
    """Fixed-arity restore result.  ``opt_state``/``ema_params`` are None when
    the checkpoint (or the caller's template) does not include them."""

    step: int
    params: Any
    training_loss: list
    opt_state: Any = None
    ema_params: Any = None


def _key_name(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(f"unsupported pytree path entry {entry!r}")


def _flatten(prefix: str, tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join([prefix] + [_key_name(e) for e in path]): np.asarray(x)
            for path, x in leaves}


def _unflatten(prefix: str, data, template):
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, like in paths:
        key = "/".join([prefix] + [_key_name(e) for e in path])
        if key not in data:
            raise KeyError(f"checkpoint has no entry {key!r}")
        arr = data[key]
        if arr.shape != np.shape(like):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"template shape {np.shape(like)}")
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    found = (_FILE_RE.match(f) for f in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.npz")


def save_checkpoint(directory: str, step: int, params: Any, opt_state: Any,
                    training_loss, ema_params: Any = None) -> None:
    """Save params + optimizer state + loss history (the reference's
    torch.save dict {epoch, model, optimizer, training_loss},
    main_pn.py:258-264).  ``ema_params``: optional EMA shadow of the
    parameters (TrainConfig.ema_decay).  Keeps the newest ``MAX_TO_KEEP``
    steps."""
    os.makedirs(directory, exist_ok=True)
    arrays = {"step": np.asarray(step, np.int64),
              "training_loss": np.asarray(training_loss, np.float64)}
    arrays.update(_flatten("params", params))
    if opt_state is not None:
        arrays.update(_flatten("opt_state", opt_state))
    if ema_params is not None:
        arrays.update(_flatten("ema_params", ema_params))
    tmp = os.path.join(directory, f".tmp_ckpt_{step}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, _path(directory, step))   # atomic: no torn checkpoints
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint_file(path: str, params_template: Any,
                         opt_state_template: Any = None
                         ) -> RestoredCheckpoint:
    """Restore one checkpoint file (e.g. a committed ``artifacts/*.npz``).

    ``opt_state`` is restored only when a template is given AND the file
    carries one (the reference restores the optimizer too,
    main_pn.py:66-73); ``ema_params`` whenever the file carries them."""
    with np.load(path) as data:
        keys = set(data.files)
        has = lambda prefix: any(k.startswith(prefix + "/") for k in keys)
        return RestoredCheckpoint(
            step=int(data["step"]),
            params=_unflatten("params", data, params_template),
            training_loss=[float(x) for x in data["training_loss"]],
            opt_state=(_unflatten("opt_state", data, opt_state_template)
                       if opt_state_template is not None
                       and has("opt_state") else None),
            ema_params=(_unflatten("ema_params", data, params_template)
                        if has("ema_params") else None))


def restore_checkpoint(directory: str, params_template: Any,
                       opt_state_template: Any = None
                       ) -> Optional[RestoredCheckpoint]:
    """Restore the latest checkpoint in ``directory`` as a
    :class:`RestoredCheckpoint` (None if the directory holds none)."""
    step = latest_step(directory)
    if step is None:
        return None
    return load_checkpoint_file(_path(directory, step), params_template,
                                opt_state_template)
