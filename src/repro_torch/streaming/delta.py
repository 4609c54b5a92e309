"""WAL-style delta log: format-v3 segments alongside the base artifact.

The JAX package's ``streaming.delta`` on the port, with the same layout,
keys and metadata, so a log written by either package replays in the other
(the fingerprint below reads only spec fields and packed rows).

Layout::

    <path>/spec.json, arrays.npz      # the immutable base (index format v3)
    <path>/delta/step_0/              # one ft.checkpoint dir per flush
    <path>/delta/step_1/              #   arrays.npz: "<seq>.<kind>" -> array
    ...                               #   manifest.json: metadata w/ v3 marker

Each segment is an *ordered* batch of ops — ``append`` (raw input vectors),
``delete`` (global ids), ``repair`` (the tombstones whose in-edge patching
drained at a snapshot boundary; recording the drain point is what makes the
lazily-repaired adjacency replay bit-identically).  Segments are written
atomically by ``ft.checkpoint.save`` (tmp-dir + fsync + crash-ordered
rename), so a crash mid-flush leaves the log readable at the previous
segment; ``ft.checkpoint.steps`` enumerates completed segments in order.

Integrity + recovery.  Every segment manifest carries per-array checksums
(written by ``ft.checkpoint``); :func:`verify_segment` re-checks them, and
:func:`recover` walks the log in order, quarantines the first corrupted (or
missing — a gap means later segments would replay against the wrong state)
segment to ``<path>/delta/quarantine/`` *together with the entire suffix
behind it*, and leaves a log whose good prefix replays bit-deterministically.
Strict readers (:func:`read_segments` / :func:`replay`) instead fail loudly
with :class:`~repro_torch.resilience.CorruptArtifactError` — nothing ever replays
a corrupted op into silently wrong search results.

The segment metadata also pins the writer's structural knobs (``ef_build``,
``sub_batch``) — candidate search width and sub-batch boundaries shape the
repaired graph, so replay restores them per segment before applying ops.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from repro_torch import obs
from repro_torch.ft import checkpoint as ckpt
from repro_torch.index.index import DELTA_FORMAT_VERSION, KNOWN_FORMATS
from repro_torch.resilience import CorruptArtifactError

SEGMENT_KIND = "naszip-delta"


def _op_key(i: int, kind: str) -> str:
    return f"{i:06d}.{kind}"


def segment_metadata(path: str | Path):
    """Yield each segment's metadata dict, in log order (manifest-only)."""
    delta_dir = Path(path) / "delta"
    for step in ckpt.steps(delta_dir):
        manifest = json.loads(
            (delta_dir / f"step_{step}" / "manifest.json").read_text())
        yield manifest.get("metadata", {})


def base_fingerprint(index) -> str:
    """Cheap content digest of a base index: shape/spec fields plus sampled
    packed rows.  Recorded in every delta segment and re-checked at replay,
    so a WAL can never be silently applied to the wrong base."""
    n = index.n
    sample = index.db_packed[:: max(1, n // 64)]
    h = hashlib.sha1()
    h.update(f"{n}/{index.dim}/{index.metric}/{index.graph.entry}".encode())
    h.update(np.ascontiguousarray(sample).tobytes())
    return h.hexdigest()[:16]


def save_delta(mindex, path: str | Path) -> Path:
    """Persist ``mindex``'s base (once) + its un-flushed WAL as one segment.

    The log is bound to one directory: once a flush (or a replay) has
    consumed part of the WAL, saving to a *different* path would silently
    produce a log missing those earlier segments, so it is rejected.
    """
    path = Path(path)
    bound = getattr(mindex, "_delta_path", None)
    if bound is not None and Path(bound).resolve() != path.resolve():
        raise ValueError(
            f"delta log is bound to {bound} (earlier segments live there); "
            f"cannot save_delta to {path} — the flushed ops are no longer "
            "in memory")
    if not (path / "spec.json").exists():
        mindex.base.save(path)
    else:
        meta = json.loads((path / "spec.json").read_text())
        if meta.get("format_version") not in KNOWN_FORMATS:
            raise ValueError(f"{path} holds an unreadable base "
                             f"(format v{meta.get('format_version')})")
        # the dir pre-exists: never silently adopt a foreign base — compare
        # the recorded fingerprint of existing segments (manifest-only read)
        # or, absent any, the base spec itself
        first = next(iter(segment_metadata(path)), None)
        if first is not None:
            if first.get("base_fingerprint") != base_fingerprint(mindex.base):
                raise ValueError(
                    f"{path} holds a delta log for a different base index "
                    "(fingerprint mismatch); refusing to append")
        elif meta.get("spec") != mindex.spec.to_dict():
            raise ValueError(
                f"{path} holds an index built from a different spec; "
                "refusing to append a delta log to a foreign base")
    if not mindex._wal:
        return path
    delta_dir = path / "delta"
    done = ckpt.steps(delta_dir)
    seq = (done[-1] + 1) if done else 0
    if seq < mindex._delta_seq:
        seq = mindex._delta_seq
    ops = {_op_key(i, kind): np.asarray(arr)
           for i, (kind, arr) in enumerate(mindex._wal)}
    with obs.span("wal.flush", seq=seq, n_ops=len(ops)):
        ckpt.save(delta_dir / f"step_{seq}", step=seq, tree=ops,
                  metadata=dict(format_version=DELTA_FORMAT_VERSION,
                                kind=SEGMENT_KIND, n_ops=len(ops),
                                generation=mindex.generation,
                                ef_build=mindex.ef_build,
                                sub_batch=mindex.sub_batch,
                                relink_floor=mindex.relink_floor,
                                base_fingerprint=base_fingerprint(mindex.base)))
    obs.default_registry().counter("streaming.wal_flushes").inc()
    obs.default_registry().counter("streaming.wal_ops_flushed").inc(len(ops))
    mindex._wal.clear()
    mindex._delta_seq = seq + 1
    mindex._delta_path = path
    return path


def _read_segment(seg: Path):
    """Load + verify one segment; returns ``(metadata, ops)``.

    Raises :class:`CorruptArtifactError` on an unreadable manifest, a torn
    ``arrays.npz``, or a checksum mismatch (via ``ckpt.restore``); plain
    ``ValueError`` when the directory is a valid checkpoint but not a naszip
    delta segment (a layout mistake, not corruption).
    """
    try:
        manifest = json.loads((seg / "manifest.json").read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptArtifactError(
            f"{seg}: unreadable segment manifest ({e})") from e
    md = manifest.get("metadata", {})
    if (md.get("format_version") != DELTA_FORMAT_VERSION
            or md.get("kind") != SEGMENT_KIND):
        raise ValueError(
            f"{seg} is not a v{DELTA_FORMAT_VERSION} naszip delta segment "
            f"(metadata {md.get('kind')!r} v{md.get('format_version')})")
    tree, _ = ckpt.restore(seg, {k: 0 for k in manifest["keys"]})
    ops = [(k.split(".", 1)[1], np.asarray(tree[k])) for k in sorted(tree)]
    return md, ops


def _present_steps(delta_dir: Path) -> set[int]:
    """Every ``step_N`` directory physically present — including ones
    ``ckpt.steps`` refuses to list (e.g. a segment whose manifest was lost).
    ``.tmp``/``.old`` crash leftovers are not segments and are excluded."""
    if not delta_dir.exists():
        return set()
    out = set()
    for d in delta_dir.iterdir():
        if not (d.is_dir() and d.name.startswith("step_")
                and not d.name.endswith((".tmp", ".old"))):
            continue
        suffix = d.name.split("_", 1)[1]
        if suffix.isdigit():
            out.add(int(suffix))
    return out


def _ordered_steps(delta_dir: Path, strict: bool = True) -> list[int]:
    """Completed segment numbers, contiguity-checked from 0.

    A gap (``step_1`` gone while ``step_2`` survives) means every later
    segment would replay against the wrong intermediate state, and an
    *orphan* (a ``step_N`` dir that ``ckpt.steps`` won't list — its manifest
    is gone, which an atomic completed save never leaves behind) means acked
    ops would silently vanish.  Strict readers refuse both; :func:`recover`
    quarantines instead.
    """
    done = ckpt.steps(delta_dir)
    if not strict:
        return done
    orphans = sorted(_present_steps(delta_dir) - set(done))
    if orphans:
        raise CorruptArtifactError(
            f"{delta_dir}: segment step_{orphans[0]} exists but is not a "
            "complete checkpoint (manifest missing/unreadable) — acked ops "
            "would be silently dropped; run repro_torch.streaming.delta.recover()")
    if done and done != list(range(done[0], done[0] + len(done))):
        missing = sorted(set(range(done[0], done[-1])) - set(done))
        raise CorruptArtifactError(
            f"{delta_dir}: delta log has gaps (missing step(s) {missing}) — "
            "later segments cannot replay against the right state; run "
            "repro_torch.streaming.delta.recover() to quarantine the suffix")
    return done


def read_segments(path: str | Path):
    """Yield ``(metadata, [(kind, array), ...])`` per segment, in log order."""
    delta_dir = Path(path) / "delta"
    for step in _ordered_steps(delta_dir):
        yield _read_segment(delta_dir / f"step_{step}")


def verify_segment(path: str | Path, step: int) -> str | None:
    """Integrity-check one segment; returns None when sound, else the reason
    it is corrupt/unusable (without raising)."""
    seg = Path(path) / "delta" / f"step_{step}"
    try:
        _read_segment(seg)
        return None
    except (CorruptArtifactError, ValueError) as e:
        return str(e)


def recover(path: str | Path) -> dict:
    """Crash/corruption recovery of the delta log at ``path``.

    Walks segments in order; at the first corrupted or missing segment, moves
    it and *every later segment* into ``<path>/delta/quarantine/`` (nothing is
    deleted — the bytes stay for forensics), leaving a contiguous good prefix
    that replays bit-deterministically.  Returns a report::

        {"good": [0, 1], "quarantined": [2, 3], "reason": "...", ...}
    """
    delta_dir = Path(path) / "delta"
    done = set(ckpt.steps(delta_dir))
    present = sorted(_present_steps(delta_dir))
    good, bad_from, reason = [], None, None
    expect = 0
    for step in present:
        if step != expect:
            bad_from, reason = expect, (f"missing segment step_{expect} "
                                        "(log gap)")
            break
        if step not in done:
            bad_from, reason = step, (f"segment step_{step} is incomplete "
                                      "(manifest missing/unreadable)")
            break
        err = verify_segment(path, step)
        if err is not None:
            bad_from, reason = step, err
            break
        good.append(step)
        expect = step + 1
    quarantined = []
    if bad_from is not None:
        qdir = delta_dir / "quarantine"
        qdir.mkdir(parents=True, exist_ok=True)
        for step in [s for s in present if s >= bad_from]:
            seg = delta_dir / f"step_{step}"
            dst = qdir / seg.name
            i = 0
            while dst.exists():       # earlier recovery of the same step
                i += 1
                dst = qdir / f"{seg.name}.{i}"
            seg.rename(dst)
            quarantined.append(step)
    return dict(good=good, quarantined=quarantined, reason=reason,
                n_good=len(good), n_quarantined=len(quarantined))


def replay(mindex, path: str | Path) -> int:
    """Apply every delta segment at ``path`` to ``mindex``, in order.

    Segments record a fingerprint of the base they were logged against;
    a WAL pointed at the wrong base fails loudly instead of replaying into
    silently wrong results.
    """
    fp = base_fingerprint(mindex.base)
    n_ops = 0
    for md, ops in read_segments(path):
        seg_fp = md.get("base_fingerprint")
        if seg_fp is not None and seg_fp != fp:
            raise ValueError(
                f"delta log at {path} was recorded against a different base "
                f"index (fingerprint {seg_fp} != {fp})")
        mindex.ef_build = int(md.get("ef_build", mindex.ef_build))
        mindex.sub_batch = int(md.get("sub_batch", mindex.sub_batch))
        mindex.relink_floor = int(md.get("relink_floor", mindex.relink_floor))
        for kind, arr in ops:
            mindex._apply(kind, arr)
            n_ops += 1
    done = ckpt.steps(Path(path) / "delta")
    mindex._delta_seq = done[-1] + 1 if done else 0
    if done:
        mindex._delta_path = Path(path)
    return n_ops
