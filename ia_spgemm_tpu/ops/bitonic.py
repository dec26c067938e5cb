"""Row-local ELL SpGEMM: the flat product grid and the width-class
(`tiled`) engine.

The reference's row-wise kernels accumulate each output row on its own
(CSR linked lists, csr/common_csr.h:130-189; ELL masks,
ell/common_ell.h:134-187). Here each row's candidate products are laid
out along one row of a (rows, width) grid and sort-compressed in-row
(ops/rowsort.py):

- flat (spgemm_bitonic): every row gets Ka*Kb slots — the ELL product
  grid of ops/ell.py, behind a viability planner.
- width classes (multiclass_planned / spgemm_bitonic_multiclass): each
  row gets its own product count padded to a pow2 class width, and the
  rows of one class share one grid, so a few long rows no longer pad
  every row. The expansion is ragged: slot s of a row reads the A entry
  whose B row covers s, so B-skew costs no padding either.

The module keeps its historical name; no sorting network is left in it.

Viability: a row's products must fit MAX_WIDTH slots and the grid must
fit the device's product budget — the role the reference's size guards
play (dia/common_dia.h:56); callers fall back to the ESC path otherwise.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import ELL, BlockCSR
from ia_spgemm_tpu.ops import ell as ell_ops
from ia_spgemm_tpu.ops.rowsort import (
    SENTINEL,
    compress_sorted_rows,
    sort_compress_rows,
)
from ia_spgemm_tpu.utils.scans import segment_broadcast

# Widest product row either engine lays out: wider rows pad the grid
# more than they save over the global sort.
MAX_WIDTH = 16384
# Share of device memory the (key, value) product grid may take.
PRODUCT_BUDGET_FRACTION = 1 / 4
# Class widths start at one 128-slot BlockCSR block.
MIN_CLASS_WIDTH = 128


def product_budget_bytes() -> int:
    return cfg.memory_budget(PRODUCT_BUDGET_FRACTION)


@dataclasses.dataclass(frozen=True)
class BitonicPlan:
    width: int        # product slots per row (Ka * Kb)
    viable: bool
    reason: str = ""


def _next_pow2_arr(x: np.ndarray) -> np.ndarray:
    """Vectorized next-pow2 (np.log2 is exact on dyadics, so ceil is
    safe)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    return (np.int64(1) << np.ceil(np.log2(x)).astype(np.int64))


def plan_bitonic_dims(m: int, ka: int, kb: int) -> BitonicPlan:
    """Plan the flat grid from dimensions only (probe before converting
    to ELL)."""
    width = max(int(ka) * int(kb), 1)
    if width > MAX_WIDTH:
        return BitonicPlan(width, False,
                           f"ka*kb={width} exceeds {MAX_WIDTH} slots per row")
    budget = product_budget_bytes()
    if m * width * 8 > budget:
        return BitonicPlan(width, False,
                           f"m*width*8={m * width * 8} exceeds "
                           f"product budget {budget}")
    return BitonicPlan(width, True)


def plan_bitonic(A: ELL, B: ELL) -> BitonicPlan:
    return plan_bitonic_dims(A.nrows, A.max_nnz_per_row, B.max_nnz_per_row)


def _pack_colval(c, prod):
    """(col | bf16(product)) packed int32 key: col in bits 30..16
    (col <= 32767 so the top bit stays 0 and signed compares order
    correctly), round-to-nearest-even bf16 bits of the f32 product in
    bits 15..0. enc is capped at 0xFFFE so no real key ever equals the
    0x7FFFFFFF sentinel (the cap only remaps one NaN pattern)."""
    s16 = jnp.int32(16)  # literal 16 promotes to i64 under x64
    pbits = jax.lax.bitcast_convert_type(prod, jnp.int32)
    rnd = pbits + jnp.int32(0x7FFF) + ((pbits >> s16) & 1)
    enc = jnp.minimum(jax.lax.shift_right_logical(rnd, s16),
                      jnp.int32(0xFFFE))
    return (c.astype(jnp.int32) << s16) | enc


def _unpack_colval(p):
    """Inverse of _pack_colval: (cols-with-SENTINEL, f32 values).
    bf16 -> f32 widening is exact (bits << 16)."""
    s16 = jnp.int32(16)
    is_sent = p == SENTINEL
    k = jnp.where(is_sent, SENTINEL, jax.lax.shift_right_logical(p, s16))
    vbits = jnp.where(is_sent, jnp.int32(0),
                      (p & jnp.int32(0xFFFF)) << s16)
    return k, jax.lax.bitcast_convert_type(vbits, jnp.float32)


@functools.partial(jax.jit, static_argnames=("out_width", "bf16"))
def _flat_core(a_col, a_val, b_col, b_val, *, out_width: int, bf16: bool):
    key, val = ell_ops.expand_rows(a_col, a_val, b_col, b_val)
    if not bf16:
        return sort_compress_rows(key, val, out_width=out_width)
    # bf16 lane: one packed int32 array sorts instead of a (key, value)
    # pair; the column still decides the order, so runs stay adjacent
    packed = jnp.where(key == SENTINEL, SENTINEL, _pack_colval(key, val))
    col, v = _unpack_colval(jax.lax.sort(packed, dimension=1))
    out_col, (out_val,), nnz = compress_sorted_rows(col, (v,),
                                                    out_width=out_width)
    return out_col, out_val, nnz


def spgemm_bitonic(A: ELL, B: ELL, plan: BitonicPlan | None = None,
                   out_width: int | None = None,
                   value_mode: str = "f32") -> ELL:
    """C = A @ B over the flat (m, Ka*Kb) product grid. Returns canonical
    left-justified ELL with ascending columns per row.

    out_width: optional cap on the returned ELL width. CONTRACT: the
    caller guarantees every output row's nnz fits (e.g. from a previous
    run's nnz_row); surplus entries are dropped and nnz_row is clamped.

    value_mode="bf16": OPT-IN serving lane — each product is rounded to
    bfloat16 and packed with its column into ONE int32 sort key, so the
    sort moves one array instead of two. Per-product relative error
    ~2^-9 (sums still accumulate in f32); the result does NOT meet the
    harness's 1e-4 checksum gate, so it is a secondary mode, never the
    default. Requires f32 inputs, B.ncols <= 32768 and finite
    products."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if value_mode not in ("f32", "bf16"):
        raise ValueError(f"unknown value_mode {value_mode!r}")
    if plan is None:
        plan = plan_bitonic(A, B)
    if not plan.viable:
        raise ValueError(f"bitonic plan not viable: {plan.reason}")
    bf16 = value_mode == "bf16"
    if bf16:
        if (A.values.dtype != jnp.float32
                or B.values.dtype != jnp.float32):
            raise ValueError("value_mode='bf16' takes float32 operands")
        if B.ncols > 32768:
            raise ValueError(
                f"value_mode='bf16' packs columns into 15 bits; "
                f"n={B.ncols} > 32768")
    out_w = min(out_width or plan.width, plan.width, B.ncols)
    col, out_val, nnz_row = _flat_core(
        A.col_ind, A.values, B.col_ind, B.values, out_width=max(out_w, 1),
        bf16=bf16)
    return ELL(col_ind=col, values=out_val, nnz_row=nnz_row,
               nnz=jnp.sum(nnz_row).astype(jnp.int32),
               shape=(A.nrows, B.ncols))


# ---------------------------------------------------------------------------
# Width classes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiClassPlan:
    widths: tuple     # ascending per-class product widths
    viable: bool
    reason: str = ""


@jax.jit
def _row_products(a_col, b_len):
    lens = b_len[jnp.clip(a_col, 0, b_len.shape[0] - 1)]
    return jnp.sum(jnp.where(a_col >= 0, lens, 0), axis=1, dtype=jnp.int32)


def row_products(A: ELL, B: ELL) -> np.ndarray:
    """Exact intermediate products per A row (sum of the B row lengths
    its entries hit), computed on device; (m,) comes back."""
    return np.asarray(_row_products(A.col_ind, B.nnz_row)).astype(np.int64)


def plan_multiclass(row_prods, *, max_classes: int = 4,
                    value_bytes: int = 4):
    """Plan per-row width classes: each row's products pad to ITS OWN
    pow2 width (the reference's ELL kernel pays the global-K tax instead,
    ell/common_ell.h:117-133); the class with the fewest rows merges into
    the next wider one until at most max_classes remain.

    Returns (MultiClassPlan, per-row width array)."""
    p = np.asarray(row_prods, dtype=np.int64)
    W = np.maximum(MIN_CLASS_WIDTH, _next_pow2_arr(np.maximum(p, 1)))
    if int(W.max(initial=MIN_CLASS_WIDTH)) > MAX_WIDTH:
        return (MultiClassPlan((), False,
                               f"a row's products exceed {MAX_WIDTH} slots"),
                W)
    classes = np.unique(W)
    while len(classes) > max_classes:
        counts = np.array([(W == w).sum() for w in classes[:-1]])
        i = int(np.argmin(counts))
        W[W == classes[i]] = classes[i + 1]
        classes = np.unique(W)
    if int(W.sum()) * (4 + value_bytes) > product_budget_bytes():
        return (MultiClassPlan((), False,
                               "summed class grids exceed the product "
                               "budget"), W)
    return MultiClassPlan(tuple(int(w) for w in classes), True), W


def multiclass_viable(row_prods, value_bytes: int = 4) -> bool:
    """Probe: can the width-class engine take rows with these product
    counts? Only each row's OWN products must fit MAX_WIDTH, so skewed
    matrices whose flat plan is rejected often pass."""
    plan, _ = plan_multiclass(row_prods, value_bytes=value_bytes)
    return plan.viable


def _class_grid(a_col, a_val, b_col, b_val, b_len, idx, *, width: int):
    """Ragged product grid of one class: row r of the class holds its
    products back to back in (n_pad, width) slots; slot s reads the A
    entry whose B row covers s (a per-row segment broadcast)."""
    ac = jnp.take(a_col, idx, axis=0, mode="fill", fill_value=-1)
    av = jnp.take(a_val, idx, axis=0, mode="fill", fill_value=0)
    k, kb = b_col.shape
    n, ka = ac.shape
    brow = jnp.clip(ac, 0, k - 1)
    lens = jnp.where(ac >= 0, b_len[brow], 0)
    end = jnp.cumsum(lens, axis=1, dtype=jnp.int32)
    start = end - lens
    ent = jax.lax.broadcasted_iota(jnp.int32, (n, ka), 1)
    e = jax.vmap(lambda v, s, a: segment_broadcast(
        v, s, a, width, jnp.int32(0)))(ent, start, lens > 0)
    slot = jax.lax.broadcasted_iota(jnp.int32, (n, width), 1)
    valid = slot < end[:, -1:]
    within = jnp.clip(slot - jnp.take_along_axis(start, e, axis=1),
                      0, kb - 1)
    src = jnp.take_along_axis(brow, e, axis=1)
    val_dtype = jnp.result_type(a_val.dtype, b_val.dtype)
    prod = (jnp.take_along_axis(av, e, axis=1).astype(val_dtype)
            * b_val[src, within].astype(val_dtype))
    key = jnp.where(valid, b_col[src, within], SENTINEL)
    return key, jnp.where(valid, prod, 0)


@functools.lru_cache(maxsize=64)
def _multiclass_fn(widths: tuple, out_w: int, m: int, assemble: str):
    """Build + jit the whole multi-class pipeline ONCE per static
    signature: one dispatch expands and sort-compresses every class and
    reassembles rows.

    assemble: "ell" scatters every class into one (m, out_w) ELL — the
    right shape when out_w is near the mean row width; "bcsr" gathers the
    per-class compact blocks into a 128-aligned BlockCSR, nnz-scaled —
    the right shape for skewed outputs where out_w is dominated by a few
    huge rows."""

    def f(a_col, a_val, b_col, b_val, b_len, *rest):
        idxs = rest[:len(widths)]
        cols_p, vals_p, nnz_p = [], [], []
        for c, w in enumerate(widths):
            key, val = _class_grid(a_col, a_val, b_col, b_val, b_len,
                                   idxs[c], width=w)
            col_c, val_c, nnz_c = sort_compress_rows(
                key, val, out_width=min(out_w, w))
            cols_p.append(col_c)
            vals_p.append(val_c)
            nnz_p.append(nnz_c)
        if assemble == "bcsr":
            src_full, blk_ptr = rest[len(widths):]
            return _assemble_bcsr(cols_p, vals_p, nnz_p, idxs, src_full,
                                  blk_ptr, m=m)
        # per-class drop-mode row scatters at each class's own width
        col = jnp.full((m, out_w), -1, jnp.int32)
        val = jnp.zeros((m, out_w), vals_p[0].dtype)
        nnz = jnp.zeros((m,), jnp.int32)
        for c in range(len(widths)):
            oc = cols_p[c].shape[1]
            col = col.at[idxs[c], :oc].set(cols_p[c], mode="drop")
            val = val.at[idxs[c], :oc].set(vals_p[c], mode="drop")
            nnz = nnz.at[idxs[c]].set(nnz_p[c], mode="drop")
        return col, val, nnz

    return jax.jit(f)


def _assemble_bcsr(cols_p, vals_p, nnz_p, idxs, src_full, blk_ptr, *,
                   m: int):
    """Gather the per-class compact outputs into 128-aligned BlockCSR
    with PLAN-CONSTANT block spans: row r owns ocs[class(r)]/128 blocks
    (0 when r has no products), so blk_ptr and the source-block
    permutation src_full are host constants baked at plan time and the
    assembly is one constant-index block gather. Spans may exceed the
    row's true nnz; the extra slots are already clean (-1 cols / 0 vals)
    because the compress step pads its outputs."""
    nnz = jnp.zeros((m,), jnp.int32)
    for c in range(len(cols_p)):
        nnz = nnz.at[idxs[c]].set(nnz_p[c], mode="drop")
    col_src = jnp.concatenate([c.reshape(-1, 128) for c in cols_p], axis=0)
    val_src = jnp.concatenate([v.reshape(-1, 128) for v in vals_p], axis=0)
    return blk_ptr, col_src[src_full], val_src[src_full], nnz


def multiclass_planned(A: ELL, B: ELL, *, max_classes: int = 4,
                       out_width: int | None = None,
                       assemble: str = "ell"):
    """Plan the width-class pipeline ONCE and return a zero-argument
    callable that runs it (None when not viable). Repeat calls with the
    same operand objects reuse the built plan (see _BUILD_CACHE)."""
    return _multiclass_build(A, B, max_classes=max_classes,
                             out_width=out_width, assemble=assemble)


def spgemm_bitonic_multiclass(A: ELL, B: ELL, *, max_classes: int = 4,
                              out_width: int | None = None,
                              assemble: str = "ell"):
    """C = A @ B with per-row width classes sharing ONE jitted dispatch.

    assemble="ell" returns a unified ELL padded to the LARGEST class
    width; assemble="bcsr" returns a BlockCSR built by one nnz-scaled
    block gather (see _assemble_bcsr). Returns None when not viable
    (caller falls back to ESC)."""
    call = _multiclass_build(A, B, max_classes=max_classes,
                             out_width=out_width, assemble=assemble)
    return call() if call is not None else None


# Planning-artifact cache: the built pipeline (class partition, jitted
# fn, device index arrays), keyed by the IDENTITY of the operand arrays
# (jax arrays are immutable, so identical objects imply identical
# content — no readback or content hash needed). Each entry pins its
# operands, so a live entry's ids can never be recycled onto different
# arrays; the FIFO bound caps the device memory pinned plans hold.
_BUILD_CACHE: dict = {}
_BUILD_CACHE_STATS = {"hits": 0, "misses": 0}
_BUILD_CACHE_MAX = 2


def clear_plan_cache():
    _BUILD_CACHE.clear()
    _BUILD_CACHE_STATS.update(hits=0, misses=0)


def plan_cache_stats():
    return dict(_BUILD_CACHE_STATS)


def _multiclass_build(A: ELL, B: ELL, *, max_classes: int,
                      out_width: int | None, assemble: str = "ell"):
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if assemble not in ("ell", "bcsr"):
        raise ValueError(f"unknown assemble mode {assemble!r}")
    anchors = (A.col_ind, A.values, A.nnz_row,
               B.col_ind, B.values, B.nnz_row)
    key = (tuple(id(x) for x in anchors), max_classes, out_width, assemble)
    cached = _BUILD_CACHE.get(key)
    if cached is not None:
        _BUILD_CACHE_STATS["hits"] += 1
        return cached[0]
    _BUILD_CACHE_STATS["misses"] += 1
    call = _multiclass_build_uncached(A, B, max_classes=max_classes,
                                      out_width=out_width,
                                      assemble=assemble)
    if len(_BUILD_CACHE) >= _BUILD_CACHE_MAX:
        _BUILD_CACHE.pop(next(iter(_BUILD_CACHE)))
    # anchors stored alongside: a None call (inviable plan) closes over
    # nothing, so the ids must be pinned explicitly to stay unique
    _BUILD_CACHE[key] = (call, anchors)
    return call


def _multiclass_build_uncached(A: ELL, B: ELL, *, max_classes: int,
                               out_width: int | None, assemble: str):
    m = A.nrows
    value_bytes = jnp.dtype(
        jnp.result_type(A.values.dtype, B.values.dtype)).itemsize
    plan, W = plan_multiclass(row_products(A, B), max_classes=max_classes,
                              value_bytes=value_bytes)
    if not plan.viable:
        return None
    widths = plan.widths
    out_w = int(widths[-1]) if out_width is None \
        else min(int(out_width), int(widths[-1]))
    if assemble == "bcsr":
        # every class output width must be a whole number of 128-slot
        # blocks (class widths are; a caller-supplied cap may not be)
        out_w = -(-out_w // 128) * 128
    idxs, counts, idx_h = [], [], []
    for w in widths:
        idx = np.nonzero(W == w)[0]
        n_pad = cfg.bucket_capacity(max(len(idx), 1))
        idxs.append(jnp.asarray(
            np.pad(idx, (0, n_pad - len(idx)),
                   constant_values=m).astype(np.int32)))
        idx_h.append(idx)
        counts.append(n_pad)
    fn = _multiclass_fn(tuple(widths), out_w, m, assemble)
    extra = []
    if assemble == "bcsr":
        extra = _bcsr_maps(A, widths, counts, idx_h, out_w)
    shape = (A.nrows, B.ncols)

    def call():
        out = fn(A.col_ind, A.values, B.col_ind, B.values, B.nnz_row,
                 *idxs, *extra)
        if assemble == "bcsr":
            blk_ptr, colb, valb, nnz_row = out
            return BlockCSR(blk_ptr=blk_ptr, col_blocks=colb,
                            val_blocks=valb, nnz_row=nnz_row,
                            nnz=jnp.sum(nnz_row).astype(jnp.int32),
                            shape=shape)
        col, val, nnz_row = out
        return ELL(col_ind=col, values=val, nnz_row=nnz_row,
                   nnz=jnp.sum(nnz_row).astype(jnp.int32), shape=shape)

    call.widths = widths
    return call


def _bcsr_maps(A: ELL, widths, counts, idx_h, out_w):
    """Plan-constant BlockCSR spans: row r owns ocs[class]/128 blocks (0
    when r cannot produce output — an empty A row), so both blk_ptr and
    the block-source permutation are host constants."""
    m = A.nrows
    ocs = [min(out_w, int(w)) for w in widths]
    nblk = [counts[c] * ocs[c] // 128 for c in range(len(widths))]
    base = np.concatenate([[0], np.cumsum(nblk)])
    lens_h = np.asarray(A.nnz_row).astype(np.int64)
    src_start_h = np.zeros(m, np.int64)
    bpr_h = np.zeros(m, np.int64)
    for c in range(len(widths)):
        src_start_h[idx_h[c]] = base[c] + np.arange(
            len(idx_h[c]), dtype=np.int64) * (ocs[c] // 128)
        bpr_h[idx_h[c]] = ocs[c] // 128
    bpr_h[lens_h == 0] = 0
    blk_ptr_h = np.concatenate([[0], np.cumsum(bpr_h)])
    nb_out = int(blk_ptr_h[-1])
    src_full_h = np.repeat(src_start_h, bpr_h) \
        + (np.arange(nb_out, dtype=np.int64)
           - np.repeat(blk_ptr_h[:-1], bpr_h))
    return [jnp.asarray(src_full_h.astype(np.int32)),
            jnp.asarray(blk_ptr_h.astype(np.int32))]
