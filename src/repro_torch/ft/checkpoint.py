"""Checkpoints of nested dicts and lists of numpy arrays and torch tensors.

The JAX package's ``ft.checkpoint`` without JAX: the same on-disk layout, so
either package restores the other's checkpoints.

  * a tree of nested dicts / lists / tuples is flattened to ``"/"``-joined
    keys (dict keys sorted, sequence positions as indices, ``None`` holds no
    leaf) — the keys and order of ``jax.tree_util.tree_flatten_with_path``;
  * ``<dir>/arrays.npz`` holds the leaves (tensors copied to the host,
    bfloat16 stored as its ``uint16`` bit view) and ``<dir>/manifest.json``
    the step, the sorted keys, each leaf's dtype, per-array checksums
    (``repro_torch.resilience.checksum``) and user metadata;
  * atomic AND crash-ordered: write into ``<dir>.tmp`` (fsync), rename the
    previous checkpoint aside to ``<dir>.old``, rename the replacement in,
    then remove the old — a crash in *any* window leaves either the old or
    the new checkpoint recoverable (``_recover_dir``);
  * verified: ``restore`` re-checks every array and raises
    :class:`~repro_torch.resilience.CorruptArtifactError` on a flipped bit or
    torn tail instead of returning garbage.

Crash windows (all fault-injectable, see ``repro_torch.resilience.faults``):

    ckpt.write_arrays   arrays.npz torn mid-write  -> stale ``.tmp``, ignored
    ckpt.pre_swap       tmp complete, no swap yet  -> stale ``.tmp``, ignored
    ckpt.mid_swap       old renamed aside          -> ``.old`` renamed back
    ckpt.post_swap      new in place, old lingers  -> ``.old`` removed
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.resilience import checksum as cks
from repro_torch.resilience import faults


def _flatten(tree, prefix=()) -> dict:
    """``{"a/0/b": leaf}`` in the key order JAX's path flattening gives."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {"/".join(str(p) for p in prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _unflatten(tree, flat: dict, prefix=()):
    """Rebuild ``tree``'s structure with the leaves of ``flat``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, flat, prefix + (i,))
                          for i, v in enumerate(tree))
    return flat["/".join(str(p) for p in prefix)]


def _to_host(v) -> tuple[np.ndarray, str]:
    """(npz-storable array, logical dtype name) of one leaf."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    if a.dtype.kind == "V" or "bfloat16" in str(a.dtype):
        return a.view(np.uint16), "bfloat16"   # npz can't store bfloat16
    return a, str(a.dtype)


def _fsync_path(path: Path) -> None:
    """fsync one file (or directory entry) — crash durability, not atomicity."""
    flags = os.O_RDONLY | (os.O_DIRECTORY if path.is_dir() else 0)
    try:
        fd = os.open(path, flags)
    except OSError:
        return          # platforms without O_DIRECTORY dir-fsync support
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _old_dir(ckpt_dir: Path) -> Path:
    return ckpt_dir.with_suffix(".old")


def _recover_dir(ckpt_dir: Path) -> bool:
    """Heal the crash windows of :func:`save` for one checkpoint directory.

    * ``<dir>`` missing but ``<dir>.old`` present (crash mid-swap): the old
      checkpoint is the last durable state — rename it back.
    * both present (crash post-swap): the replacement won — drop ``.old``.

    Returns True when ``ckpt_dir`` exists afterwards.
    """
    old = _old_dir(ckpt_dir)
    if ckpt_dir.exists():
        if old.exists():
            shutil.rmtree(old)
        return True
    if old.exists() and (old / "manifest.json").exists():
        old.rename(ckpt_dir)
        return True
    return ckpt_dir.exists()


def save(ckpt_dir: str | Path, step: int, tree, metadata: dict | None = None,
         async_write: bool = False) -> threading.Thread | None:
    ckpt_dir = Path(ckpt_dir)
    host, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        host[k], dtypes[k] = _to_host(v)

    def _write():
        tmp = ckpt_dir.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **host)
        faults.fault_point("ckpt.write_arrays", path=tmp / "arrays.npz")
        (tmp / "manifest.json").write_text(json.dumps(dict(
            step=step, keys=sorted(host), dtypes=dtypes,
            checksums=cks.manifest_checksums(host),
            metadata=metadata or {})))
        _fsync_path(tmp / "arrays.npz")
        _fsync_path(tmp / "manifest.json")
        _fsync_path(tmp)
        faults.fault_point("ckpt.pre_swap")
        # crash-ordered swap: the previous checkpoint is renamed ASIDE (not
        # deleted) until the replacement is fully in place — a crash between
        # the two renames loses nothing (_recover_dir renames .old back)
        old = _old_dir(ckpt_dir)
        if old.exists():
            shutil.rmtree(old)          # leftover from an earlier crash
        if ckpt_dir.exists():
            ckpt_dir.rename(old)
            faults.fault_point("ckpt.mid_swap")
        tmp.rename(ckpt_dir)
        faults.fault_point("ckpt.post_swap")
        _fsync_path(ckpt_dir.parent)
        if old.exists():
            shutil.rmtree(old)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def steps(base_dir: str | Path) -> list[int]:
    """All completed checkpoint steps under ``base_dir``, ascending.

    The streaming delta log replays *every* segment in order.  Heals crash
    leftovers first: a ``step_N.old`` whose ``step_N`` vanished mid-swap is
    renamed back (it IS the last durable state).
    """
    base = Path(base_dir)
    if not base.exists():
        return []
    for d in list(base.iterdir()):
        if d.name.endswith(".old"):
            _recover_dir(d.with_suffix(""))
    out = []
    for d in base.iterdir():
        # a crash can leave a half-written ``step_N.tmp`` behind (the writer
        # renames it into place only on completion) — never resume from one
        if not (d.is_dir() and d.name.startswith("step_")
                and not d.name.endswith((".tmp", ".old"))
                and (d / "manifest.json").exists()):
            continue
        suffix = d.name.split("_", 1)[1]
        if suffix.isdigit():
            out.append(int(suffix))
    return sorted(out)


def latest_step(base_dir: str | Path) -> int | None:
    all_steps = steps(base_dir)
    return all_steps[-1] if all_steps else None


def _bfloat16(a: np.ndarray, device):
    """A stored ``uint16`` bit view back as bfloat16: a torch tensor on
    ``device``, or (host) an ``ml_dtypes`` array."""
    if device is not None:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    try:
        import ml_dtypes
    except ImportError as e:
        raise RuntimeError("restoring a bfloat16 array as numpy needs "
                           "ml_dtypes; pass device= to get a torch tensor"
                           ) from e
    return a.view(ml_dtypes.bfloat16)


def restore(ckpt_dir: str | Path, abstract_tree, device=None, mesh=None, spec_fn=None):
    """Restore into the structure of ``abstract_tree``: numpy arrays, or
    torch tensors on ``device`` when one is named.  Returns ``(tree,
    manifest)``.

    On ``mesh`` (a live ``launch.mesh.Mesh``; ``abstract_tree`` then has the
    global shapes) each leaf is placed by the sharding rules
    (``spec_fn(abstract_tree, mesh)``, default the parameter rules): this
    rank's block, on ``device`` (default the mesh's).  The layout on disk
    is the global one whatever mesh wrote it.

    Verifies every array against the manifest's recorded checksums (when
    present) and raises :class:`~repro_torch.resilience.CorruptArtifactError`
    on corruption instead of restoring garbage state.
    """
    ckpt_dir = Path(ckpt_dir)
    _recover_dir(ckpt_dir)
    try:
        manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise cks.CorruptArtifactError(
            f"{ckpt_dir}: unreadable manifest.json ({e})") from e
    dtypes = manifest.get("dtypes", {})
    try:
        with np.load(ckpt_dir / "arrays.npz") as z:
            raw = {k: faults.corrupt("ckpt.read_arrays", z[k])
                   for k in z.files}
    except cks.CorruptArtifactError:
        raise
    except Exception as e:      # truncated/torn zip containers raise variously
        raise cks.CorruptArtifactError(
            f"{ckpt_dir}: unreadable arrays.npz ({e}) — torn write?") from e
    missing_files = set(manifest.get("keys", raw)) - set(raw)
    if missing_files:
        raise cks.CorruptArtifactError(
            f"{ckpt_dir}: arrays.npz is missing manifest keys "
            f"{sorted(missing_files)[:5]} — torn write?")
    cks.verify_arrays(raw, manifest.get("checksums"), ckpt_dir)
    flat_abs = _flatten(abstract_tree)
    missing = set(flat_abs) - set(raw)
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")
    vals = {}
    if mesh is not None:
        from repro_torch.distributed import sharding as sh

        specs = sh.flat((spec_fn or sh.param_specs)(abstract_tree, mesh))
        for k in flat_abs:
            a = raw.pop(k)
            t = (_bfloat16(a, "cpu") if dtypes.get(k) == "bfloat16"
                 else torch.from_numpy(np.array(a, order="C")))
            vals[k] = sh.place(t, specs[k], mesh, device)
        return _unflatten(abstract_tree, vals), manifest
    for k in flat_abs:
        a = raw[k]
        if dtypes.get(k) == "bfloat16":
            vals[k] = _bfloat16(a, device)
        elif device is not None:
            vals[k] = torch.from_numpy(np.array(a, order="C")).to(device)   # keeps 0-d
        else:
            vals[k] = a
    return _unflatten(abstract_tree, vals), manifest
