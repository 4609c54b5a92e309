"""NDP-aware dynamic floating-point (Dfloat) representation (paper §IV-B).

A vector's feature axis is split into segments; segment ``i`` stores features
as 1 + n_exp_i + n_man_i bit floats (Eq. 7) with a per-segment, data-derived
exponent bias.  Values are widened to f32 before any arithmetic.

Three layers:
  * emulate_*    — mask-based precision emulation on f32 (the paper's own
                   config-search trick, §IV-B2).  numpy arrays take the host
                   path; torch tensors take a bit-identical torch path, so the
                   Algorithm-1 search over a 1M-row DB runs on the card.
  * pack/unpack  — real bitstream packing into uint32 words (the deployable
                   format; the CUDA kernels in ``kernels/`` decode the same
                   layout).  :func:`pack_db` packs in torch, on the
                   input's device; :func:`unpack_rows` is the torch decoder.
                   Both carry words as int64 masked to 32 bits, because
                   torch's uint32 has no shifts or additions.
  * search_config— Algorithm 1: binary search on burst count + enumeration of
                   valid non-increasing width layouts under a recall target.

The numpy host layer is the JAX package's, unchanged, and the torch paths
give its bits, so configs, packed words and layouts are bit-identical
between the two packages.

:func:`pack_db` and the torch path of :func:`emulate_db` work in row chunks
of ``CHUNK_BYTES`` of f32 input: their int64 temporaries take twice that
each, so a whole 1M x 960 matrix at once would hold tens of GB of them.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

F32_MAN = 23
F32_BIAS = 127
CHUNK_BYTES = 1 << 28


def _row_chunks(db: torch.Tensor):
    """Row slices of ``db`` of at most ``CHUNK_BYTES`` of f32 each."""
    step = max(1, CHUNK_BYTES // (4 * max(db.shape[1], 1)))
    return (slice(r, min(r + step, db.shape[0])) for r in range(0, db.shape[0], step))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DfloatSegment:
    start: int      # first feature index
    n_dims: int
    n_exp: int
    n_man: int
    bias: int       # exponent bias B (Eq. 7)

    @property
    def width(self) -> int:
        return 1 + self.n_exp + self.n_man


@dataclasses.dataclass(frozen=True)
class DfloatConfig:
    segments: tuple[DfloatSegment, ...]
    burst_bits: int = 128           # DDR5 per-device burst (paper §IV-B2)
    devices_per_subchannel: int = 4

    @property
    def dim(self) -> int:
        return sum(s.n_dims for s in self.segments)

    def total_bits(self) -> int:
        return sum(s.n_dims * s.width for s in self.segments)

    def bursts_per_vector(self) -> int:
        """DRAM bursts to stream one full vector (rule 1: one format per
        burst; rule 4: multiple of devices-per-subchannel)."""
        n = 0
        for s in self.segments:
            per = self.burst_bits // s.width
            n += -(-s.n_dims // per)
        dev = self.devices_per_subchannel
        return -(-n // dev) * dev

    def bursts_for_prefix(self, k: int) -> int:
        """Bursts touched when FEE stops after the first ``k`` features."""
        n = 0
        left = k
        for s in self.segments:
            if left <= 0:
                break
            per = self.burst_bits // s.width
            take = min(left, s.n_dims)
            n += -(-take // per)
            left -= take
        return n

    def widths_per_dim(self) -> np.ndarray:
        w = np.empty(self.dim, np.int32)
        for s in self.segments:
            w[s.start : s.start + s.n_dims] = s.width
        return w

    def packed_row_bytes(self) -> int:
        """Bytes of one packed row (uint32 words under the burst-aligned
        layout)."""
        return 4 * packed_words(self)

    def row_burst_groups(self) -> int:
        """64B sub-channel burst groups to stream one full row (the
        ``devices_per_subchannel`` devices move in lockstep, rule 4) — the
        unit both the read and the write traffic accounting use."""
        dev = max(1, self.devices_per_subchannel)
        return -(-self.bursts_per_vector() // dev)


def fp32_config(d: int) -> DfloatConfig:
    return DfloatConfig((DfloatSegment(0, d, 8, 23, 127),))


def split_config(cfg: DfloatConfig, n_features: int) -> tuple[DfloatConfig, DfloatConfig]:
    """Split ``cfg`` at a feature boundary into two burst-aligned tier configs
    (coarse = features ``[0, n_features)``, residual = the rest, re-based);
    per-feature formats are preserved, so either tier decodes bit-identically
    to the parent layout."""
    if not 0 <= n_features <= cfg.dim:
        raise ValueError(f"n_features={n_features} outside [0, {cfg.dim}]")
    coarse, resid = [], []
    for s in cfg.segments:
        lo, hi = s.start, s.start + s.n_dims
        c_hi = min(hi, n_features)
        if c_hi > lo:
            coarse.append(DfloatSegment(lo, c_hi - lo, s.n_exp, s.n_man, s.bias))
        r_lo = max(lo, n_features)
        if hi > r_lo:
            resid.append(DfloatSegment(r_lo - n_features, hi - r_lo,
                                       s.n_exp, s.n_man, s.bias))
    return (DfloatConfig(tuple(coarse), cfg.burst_bits, cfg.devices_per_subchannel),
            DfloatConfig(tuple(resid), cfg.burst_bits, cfg.devices_per_subchannel))


def pack_tiers(db: np.ndarray, cfg: DfloatConfig,
               n_features: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack (N, D) f32 rows into the two tier bitstreams of
    ``split_config(cfg, n_features)`` (persisted by tier-native artifacts)."""
    ccfg, rcfg = split_config(cfg, n_features)
    return (pack_db(db[:, :n_features], ccfg),
            pack_db(db[:, n_features:], rcfg))


# ---------------------------------------------------------------------------
# field encode / decode / emulate (numpy)
# ---------------------------------------------------------------------------


def pick_bias(x, n_exp: int) -> int:
    """Data-derived bias: place the format's max exponent at the data's max.

    ``x`` is a numpy array or a tensor; the tensor path reduces on its device
    and takes the same float32 ``log2`` of the same maximum on the host."""
    if isinstance(x, torch.Tensor):
        amax = np.float32(x.abs().max().item()) if x.numel() else np.float32(0)
        if amax == 0:
            return (1 << (n_exp - 1)) - 1
        emax_data = int(np.floor(np.log2(amax)))
        return (1 << n_exp) - 1 - emax_data
    ax = np.abs(x[x != 0])
    if ax.size == 0:
        return (1 << (n_exp - 1)) - 1
    emax_data = int(np.floor(np.log2(ax.max())))
    return (1 << n_exp) - 1 - emax_data  # field emax -> emax_data


def encode_fields(x: np.ndarray, n_exp: int, n_man: int, bias: int) -> np.ndarray:
    """f32 -> packed Dfloat integer field (uint32, low ``1+n_exp+n_man`` bits).

    Round-to-nearest mantissa; clamp-to-max on overflow; flush-to-zero on
    underflow (no denormals, no inf/nan — the full field range encodes finite
    values, as is usual for custom NDP formats)."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    sign = (bits >> np.uint32(31)).astype(np.uint32)
    exp = ((bits >> np.uint32(F32_MAN)) & np.uint32(0xFF)).astype(np.int64)
    man = (bits & np.uint32(0x7FFFFF)).astype(np.int64)

    shift = F32_MAN - n_man
    if shift > 0:
        man = man + (1 << (shift - 1))          # round to nearest (ties away)
        exp = exp + (man >> F32_MAN)            # mantissa carry
        man = (man & 0x7FFFFF) >> shift
    field_emax = (1 << n_exp) - 1
    e = exp - F32_BIAS + bias                   # field exponent
    man_max = (1 << n_man) - 1
    # overflow -> clamp to largest finite; underflow (e < 0) or f32 zero/denorm -> 0
    over = e > field_emax
    under = (e < 0) | (exp <= 0)
    e = np.clip(e, 0, field_emax)
    man = np.where(over, man_max, man)
    fld = (sign.astype(np.int64) << (n_exp + n_man)) | (e << n_man) | man
    fld = np.where(under, np.int64(0), fld)
    return fld.astype(np.uint32)


def decode_fields(fld: np.ndarray, n_exp: int, n_man: int, bias: int) -> np.ndarray:
    fld = np.asarray(fld, np.uint32).astype(np.int64)
    sign = (fld >> (n_exp + n_man)) & 1
    e = (fld >> n_man) & ((1 << n_exp) - 1)
    man = fld & ((1 << n_man) - 1)
    zero = fld == 0
    # widen to f32 bit pattern ("zero-padded to match FP32", §IV-B3)
    f32 = (sign << 31) | ((e - bias + F32_BIAS) << F32_MAN) | (man << (F32_MAN - n_man))
    f32 = np.where(zero, np.int64(0), f32)
    return f32.astype(np.uint32).view(np.float32)


def emulate(x: np.ndarray, n_exp: int, n_man: int, bias: int) -> np.ndarray:
    return decode_fields(encode_fields(x, n_exp, n_man, bias), n_exp, n_man, bias)


def make_config(d: int, widths_bursts: list[tuple[int, int, int]],
                db=None, burst_bits: int = 128, devices: int = 4) -> DfloatConfig:
    """Build a config from [(width, n_exp, n_dims)] runs; biases from ``db``
    (numpy array or tensor)."""
    segs = []
    start = 0
    for width, n_exp, n_dims in widths_bursts:
        n_man = width - 1 - n_exp
        assert n_man >= 1 and n_exp >= 2, (width, n_exp)
        n_dims = min(n_dims, d - start)
        if n_dims <= 0:
            continue
        chunk = db[:, start : start + n_dims] if db is not None else None
        bias = pick_bias(chunk, n_exp) if chunk is not None else (1 << (n_exp - 1)) - 1
        segs.append(DfloatSegment(start, n_dims, n_exp, n_man, bias))
        start += n_dims
    assert start == d, (start, d)
    return DfloatConfig(tuple(segs), burst_bits, devices)


def emulate_db(db, cfg: DfloatConfig):
    """Quantize every feature to its segment's format and widen back to f32.

    numpy in -> numpy out (host); a tensor takes the torch path on its own
    device, bit-identical to the host path."""
    if isinstance(db, torch.Tensor):
        out = torch.empty(db.shape, dtype=torch.float32, device=db.device)
        for rows in _row_chunks(db):
            for s in cfg.segments:
                sl = slice(s.start, s.start + s.n_dims)
                fld = _encode_fields_t(db[rows, sl], s.n_exp, s.n_man, s.bias)
                out[rows, sl] = decode_field_t(fld, s.n_exp, s.n_man, s.bias)
        return out
    out = np.empty_like(db, dtype=np.float32)
    for s in cfg.segments:
        sl = slice(s.start, s.start + s.n_dims)
        out[:, sl] = emulate(db[:, sl], s.n_exp, s.n_man, s.bias)
    return out


# ---------------------------------------------------------------------------
# torch encode / decode (words carried as int64 holding 32-bit patterns)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def words_i64(packed: torch.Tensor) -> torch.Tensor:
    """uint32 or int32 (bit view) words -> int64 holding the unsigned value."""
    if packed.dtype == torch.uint32:
        packed = packed.view(torch.int32)
    return packed.to(torch.int64) & _U32


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor reinterpreted as float32."""
    bits = bits & _U32
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _encode_fields_t(x: torch.Tensor, n_exp: int, n_man: int,
                     bias: int) -> torch.Tensor:
    """Torch twin of :func:`encode_fields`: f32 -> int64 field values."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    sign = bits >> 31
    exp = (bits >> F32_MAN) & 0xFF
    man = bits & 0x7FFFFF
    shift = F32_MAN - n_man
    if shift > 0:
        man = man + (1 << (shift - 1))
        exp = exp + (man >> F32_MAN)
        man = (man & 0x7FFFFF) >> shift
    field_emax = (1 << n_exp) - 1
    e = exp - F32_BIAS + bias
    over = e > field_emax
    under = (e < 0) | (exp <= 0)
    e = e.clamp(0, field_emax)
    man = torch.where(over, (1 << n_man) - 1, man)
    fld = (sign << (n_exp + n_man)) | (e << n_man) | man
    return torch.where(under, 0, fld)


def decode_field_t(fld: torch.Tensor, n_exp: int, n_man: int,
                   bias: int) -> torch.Tensor:
    """int64 Dfloat field -> f32, bit-exact vs :func:`decode_fields`.

    ``e - bias + 127`` is computed in int64 and cut to 32 bits, which is the
    uint32 wraparound the JAX decoder relies on when ``bias > 127``."""
    sign = (fld >> (n_exp + n_man)) & 1
    e = (fld >> n_man) & ((1 << n_exp) - 1)
    man = fld & ((1 << n_man) - 1)
    f32 = (sign << 31) | (((e - bias + F32_BIAS) & _U32) << F32_MAN) \
        | (man << (F32_MAN - n_man))
    return _bits_to_f32(torch.where(fld == 0, 0, f32))


# ---------------------------------------------------------------------------
# real bitstream packing (deployable layout; the CUDA kernels decode this)
# ---------------------------------------------------------------------------


def burst_layout(cfg: DfloatConfig):
    """Static per-segment layout under the burst-aligned rule (paper Fig. 10d:
    the barrel shifter extracts fields from one 128-bit burst register, so
    fields never straddle bursts; each burst holds floor(B/width) fields).

    Returns [(seg, word_start, n_bursts, fields_per_burst)], total_words.
    """
    words_per_burst = cfg.burst_bits // 32
    out = []
    word = 0
    for s in cfg.segments:
        per = cfg.burst_bits // s.width
        nb = -(-s.n_dims // per)
        out.append((s, word, nb, per))
        word += nb * words_per_burst
    return out, word


def pack_db(db, cfg: DfloatConfig) -> np.ndarray:
    """Pack (N, D) f32 into (N, W) uint32 with the burst-aligned layout.

    ``db`` is a numpy array or a tensor, packed on its device; the words come
    back as a host array.  Each chunk of rows carries its words as int64 and
    ORs in one field position of every burst of a segment at a time."""
    if not isinstance(db, torch.Tensor):
        db = torch.from_numpy(np.ascontiguousarray(db, np.float32))
    n, d = db.shape
    assert d == cfg.dim
    layout, w_words = burst_layout(cfg)
    wpb = cfg.burst_bits // 32
    out = np.empty((n, w_words), np.uint32)
    for rows in _row_chunks(db):
        x = db[rows]
        words = torch.zeros((x.shape[0], w_words), dtype=torch.int64, device=db.device)
        for s, word0, nb, per in layout:
            fld = _encode_fields_t(x[:, s.start: s.start + s.n_dims], s.n_exp,
                                   s.n_man, s.bias)
            bursts = words[:, word0: word0 + nb * wpb].unflatten(1, (nb, wpb))
            for local in range(min(per, s.n_dims)):
                v = fld[:, local::per]              # this position, burst by burst
                bit = local * s.width
                wi, ofs = bit >> 5, bit & 31
                bursts[:, : v.shape[1], wi] |= (v << ofs) & _U32
                if ofs + s.width > 32:
                    bursts[:, : v.shape[1], wi + 1] |= v >> (32 - ofs)
        words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
        out[rows] = words.cpu().numpy().view(np.uint32)
    return out


def packed_words(cfg: DfloatConfig) -> int:
    """uint32 words per packed vector under the burst-aligned layout."""
    return burst_layout(cfg)[1]


def feature_positions(cfg: DfloatConfig):
    """Static (word index, bit offset, segment) of every feature.

    Fields never straddle a 128-bit burst (rule 1), so each feature's position
    within the packed row is a constant of the layout.  Returns (positions,
    total_words).
    """
    layout, w_words = burst_layout(cfg)
    wpb = cfg.burst_bits // 32
    pos = []
    for s, word0, nb, per in layout:
        for j in range(s.n_dims):
            burst, local = divmod(j, per)
            bit = local * s.width
            pos.append((word0 + burst * wpb + (bit >> 5), bit & 31, s))
    return pos, w_words


def decode_burst_quads(quad: torch.Tensor, s: DfloatSegment,
                       per: int) -> torch.Tensor:
    """Decode one segment's burst quads (C, nb, words/burst) of int64 words
    -> (C, nb*per) f32 with the static per-phase shifts."""
    cols = []
    for local in range(per):
        bit = local * s.width
        wi, ofs = bit >> 5, bit & 31
        v = quad[:, :, wi] >> ofs
        if ofs + s.width > 32:
            v = v | (quad[:, :, wi + 1] << (32 - ofs))
        fld = v & ((1 << s.width) - 1)
        cols.append(decode_field_t(fld, s.n_exp, s.n_man, s.bias))
    return torch.stack(cols, dim=-1).reshape(quad.shape[0], quad.shape[1] * per)


def unpack_rows(packed: torch.Tensor, cfg: DfloatConfig) -> torch.Tensor:
    """Torch decoder: (C, W) uint32/int32 words -> (C, D) f32, bit-exact vs
    :func:`unpack_db`.  The plain version of the ``dfloat_unpack`` kernel."""
    layout, _ = burst_layout(cfg)
    wpb = cfg.burst_bits // 32
    c = packed.shape[0]
    if not layout:                      # empty tier of a degenerate split
        return torch.zeros((c, 0), dtype=torch.float32, device=packed.device)
    words = words_i64(packed)
    outs = []
    for s, word0, nb, per in layout:
        quad = words[:, word0 : word0 + nb * wpb].reshape(c, nb, wpb)
        outs.append(decode_burst_quads(quad, s, per)[:, : s.n_dims])
    return torch.cat(outs, dim=1)


def unpack_db(packed: np.ndarray, cfg: DfloatConfig) -> np.ndarray:
    """Numpy reference decoder."""
    n = packed.shape[0]
    p64 = packed.astype(np.uint64)
    layout, _ = burst_layout(cfg)
    wpb = cfg.burst_bits // 32
    out = np.empty((n, cfg.dim), np.float32)
    for s, word0, nb, per in layout:
        for j in range(s.n_dims):
            burst, local = divmod(j, per)
            bit = local * s.width
            wi, ofs = word0 + burst * wpb + (bit >> 5), bit & 31
            v = p64[:, wi] >> np.uint64(ofs)
            if ofs + s.width > 32:
                v |= p64[:, wi + 1] << np.uint64(32 - ofs)
            fld = (v & np.uint64((1 << s.width) - 1)).astype(np.uint32)
            out[:, s.start + j] = decode_fields(fld, s.n_exp, s.n_man, s.bias)
    return out


# ---------------------------------------------------------------------------
# Algorithm 1 — Dfloat configuration search
# ---------------------------------------------------------------------------

WIDTH_PALETTE = (32, 24, 21, 18, 16, 14, 12)   # floor(128/w) = 4,5,6,7,8,9,10
EXP_BITS = {32: 8, 24: 8, 21: 6, 18: 6, 16: 5, 14: 5, 12: 4}


def _layouts_for_bursts(d: int, n_burst: int, burst_bits: int):
    """cfg-validate (Alg. 1 line 4): all <=3-segment non-increasing width
    layouts that fill exactly ``n_burst`` bursts and cover >= d features,
    greedily maximizing precision of leading features (rule 2/3)."""
    outs = []
    for ws in itertools.chain(
        itertools.combinations(WIDTH_PALETTE, 1),
        itertools.combinations(WIDTH_PALETTE, 2),
        itertools.combinations(WIDTH_PALETTE, 3),
    ):
        per = [burst_bits // w for w in ws]
        k = len(ws)
        if k == 1:
            if per[0] * n_burst >= d:
                outs.append([(ws[0], n_burst)])
            continue
        # choose burst counts b_i >= 0 summing to n_burst, coverage >= d,
        # lexicographically maximal (b_1, b_2, ...) = max leading precision
        best = None
        rng1 = range(n_burst, -1, -1)
        for b1 in rng1:
            rest = n_burst - b1
            if k == 2:
                b = (b1, rest)
                if per[0] * b1 + per[1] * rest >= d:
                    best = b
                    break
            else:
                got = None
                for b2 in range(rest, -1, -1):
                    b3 = rest - b2
                    if per[0] * b1 + per[1] * b2 + per[2] * b3 >= d:
                        got = (b1, b2, b3)
                        break
                if got is not None:
                    best = got
                    break
        if best is not None and all(b >= 0 for b in best):
            outs.append([(w, b) for w, b in zip(ws, best) if b > 0])
    # dedupe
    seen, uniq = set(), []
    for o in outs:
        key = tuple(o)
        if key not in seen:
            seen.add(key)
            uniq.append(o)
    return uniq


def layout_to_config(d: int, layout, db, burst_bits: int = 128,
                     devices: int = 4) -> DfloatConfig:
    runs, covered = [], 0
    for w, b in layout:
        per = burst_bits // w
        n_dims = min(per * b, d - covered)
        if n_dims > 0:
            runs.append((w, EXP_BITS[w], n_dims))
            covered += n_dims
    if covered < d:  # pad with last width
        w = layout[-1][0]
        runs.append((w, EXP_BITS[w], d - covered))
    return make_config(d, runs, db, burst_bits, devices)


def search_config(
    db,
    recall_fn,
    r_target: float,
    burst_bits: int = 128,
    devices: int = 4,
    verbose: bool = False,
) -> tuple[DfloatConfig, list]:
    """Algorithm 1.  ``recall_fn(emulated_db) -> recall@k`` on sampled queries
    (the paper evaluates with mask-emulated data, line 6).  ``db`` is a numpy
    array or a tensor; a tensor keeps every emulation on its device."""
    d = db.shape[1]
    nb_max = -(-d // (burst_bits // 32))
    nb_min = -(-d // (burst_bits // 12))
    rnd = lambda x: -(-x // devices) * devices  # rule 4
    nb_max, nb_min = rnd(nb_max), rnd(nb_min)
    best_cfg = fp32_config(d)
    best_recall = recall_fn(db)
    log = [("fp32", nb_max, float(best_recall))]
    lo, hi = nb_min, nb_max
    while lo < hi:
        mid = rnd((lo + hi) // 2)
        if mid >= hi:
            mid = hi - devices
        found = False
        for layout in _layouts_for_bursts(d, mid, burst_bits):
            cfg = layout_to_config(d, layout, db, burst_bits, devices)
            r = recall_fn(emulate_db(db, cfg))
            log.append((str(layout), mid, float(r)))
            if verbose:
                print(f"  N_burst={mid} {layout} recall={r:.4f}")
            if r >= r_target:
                best_cfg, best_recall, found = cfg, r, True
                break  # layouts are precision-sorted; first hit is enough
        if found:
            hi = mid
        else:
            lo = mid + devices
    return best_cfg, log
