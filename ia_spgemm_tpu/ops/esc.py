"""ESC (expand–sort–compress) SpGEMM — the default CSR path.

The reference's CPU CSR kernel is a Gustavson two-phase with per-thread
linked-list accumulators (csr/common_csr.h:85-193); its GPU kernels are
Thrust ESC pipelines (csr_dev/common_csr_dev.h:134-254,
coo_dev/common_coo_dev.h:178-602). The same pipeline is written here in
plain `lax`: large sorts, cumulative scans and bulk gathers, which XLA
lowers to its own device kernels:

  phase 1 (symbolic): expansion size E = sum over a_ij of nnz(B row j)
           — identical to the reference's symbolic nnz-upper-bound pass
           and to GetFlop (csr/common_csr.h:290-304).
  phase 2 (numeric): materialize all E intermediate products (i, j, a*b),
           sort by (i, j), compress equal keys by cumsum-differencing.

Design choices carried by the pipeline (none of them measured on the
card yet):
- every segment lookup uses a scatter+cummax segmented broadcast
  instead of a binary search;
- the compress phase uses a *compaction sort* of the run ends plus a
  segmented scan — no large scatters;
- pairs of arrays are packed (bitcast int32<->float32) into (n, 2)
  blocks so each logical double-gather is one XLA gather.

Because XLA requires static shapes, the data-dependent sizes (E, nnz(C))
are handled by a host-side planner that pads to geometric buckets
(bounding recompiles), and the true nnz travels as a 0-d array.
Output columns are sorted within each row (the reference emits unsorted,
reversed insertion order — csr/common_csr.h:173-187; sorted is canonical).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ia_spgemm_tpu import config as cfg
from ia_spgemm_tpu.formats.types import COO, CSR
from ia_spgemm_tpu.ops.rowsort import segmented_scan

_INT32_MAX = np.int32(np.iinfo(np.int32).max)


# Single-slab workspace ceiling: expansions above this many intermediate
# products are row-sliced (the reference caps its ESC workspace at
# min(expansion, 16M, freemem/3) and slices rows to fit,
# coo_dev/common_coo_dev.h:326-337,388-421). The sort pipeline keeps
# ~64 bytes per product live, so the workspace is device memory / 64
# (2^28 products on the CPU backend's fixed 16 GiB); int32 position
# arithmetic additionally requires slab E < 2^31.
WORKSPACE_BYTES_PER_PRODUCT = 64


def default_workspace_elems() -> int:
    return cfg.memory_budget(1.0) // WORKSPACE_BYTES_PER_PRODUCT


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Static capacities for one (A, B) SpGEMM problem."""
    expansion_capacity: int   # >= E of a slab (number of products)
    out_capacity: int         # >= nnz(C) of a slab
    flops: int                # exact total E — the reference's GetFlop(A, B)
    # Workspace slicing (reference: sliced ESC, coo_dev:388-450): row
    # boundaries [0, r1, ..., m] such that each slab's expansion fits the
    # workspace; None = single slab. All slabs share one compiled shape:
    # rows_capacity rows, nnza_capacity entries, expansion/out capacity.
    slabs: tuple | None = None
    rows_capacity: int = 0    # max rows per slab (padded)
    nnza_capacity: int = 0    # max A entries per slab (padded)
    total_out_capacity: int = 0  # >= nnz(C) overall (sliced only)


def plan_spgemm(A: CSR, B: CSR, *, bucket: bool = True,
                workspace_elems: int | None = None) -> SpGEMMPlan:
    """Symbolic pass: exact expansion size (the reference's phase-1 nnz
    upper bound, csr/common_csr.h:100-125). The per-row reduction runs on
    device (ops/symbolic.py); only (m,) row counts come back to the host
    planner — not the O(nnz) index arrays.

    Expansions beyond `workspace_elems` (default default_workspace_elems(),
    always capped below int32) get a sliced plan: greedy row slabs whose
    per-slab expansion fits, mirroring the reference's upper_bound search
    over cumulative_row_workspace (coo_dev/common_coo_dev.h:388-421)."""
    from ia_spgemm_tpu.ops import symbolic
    ws = workspace_elems or default_workspace_elems()
    ws = min(ws, np.iinfo(np.int32).max - 1)
    # bucket_capacity rounds UP (<=25%): cap ws so even the bucketed
    # capacity stays below int32 positions (a ws near 2^31 would
    # otherwise let bucket_capacity(E) overflow the position arithmetic)
    while cfg.bucket_capacity(ws) > np.iinfo(np.int32).max - 1:
        ws -= max(ws // 16, 1)
    E, out_bound, max_rf, rf = symbolic.plan_symbolic(A, B,
                                                      return_rows=True)
    if E > ws:
        if max_rf > ws:
            raise ValueError(
                f"a single row expands to {max_rf} products, beyond the "
                f"{ws}-element workspace; row-partition the problem "
                "(ia_spgemm_tpu.parallel) or raise workspace_elems")
        # greedy slabs over the row-flops prefix sum: searchsorted per
        # SLAB (the reference's upper_bound over
        # cummulative_row_workspace, coo_dev:388-421), not a Python
        # iteration per ROW
        csum = np.concatenate([[0], np.cumsum(rf, dtype=np.int64)])
        bounds = [0]
        while bounds[-1] < len(rf):
            r0 = bounds[-1]
            r1 = int(np.searchsorted(csum, csum[r0] + ws, side="right")) - 1
            bounds.append(max(r1, r0 + 1))  # max_rf<=ws ⇒ r1>r0 normally
        slabs = tuple(bounds)
        spans = [(slabs[i], slabs[i + 1]) for i in range(len(slabs) - 1)]
        row_ptr = np.asarray(A.row_ptr, dtype=np.int64)
        slab_E = max(int(rf[r0:r1].sum()) for r0, r1 in spans)
        slab_out = max(int(np.minimum(rf[r0:r1], B.ncols).sum())
                       for r0, r1 in spans)
        slab_nnz = max(int(row_ptr[r1] - row_ptr[r0]) for r0, r1 in spans)
        slab_rows = max(r1 - r0 for r0, r1 in spans)
        total_out = int(np.minimum(rf, B.ncols).sum())
        if total_out >= np.iinfo(np.int32).max:
            raise ValueError(
                f"output bound {total_out} overflows int32 positions; "
                "row-partition the problem (ia_spgemm_tpu.parallel)")
        return SpGEMMPlan(
            expansion_capacity=cfg.bucket_capacity(slab_E, enabled=bucket),
            out_capacity=cfg.bucket_capacity(slab_out or 1, enabled=bucket),
            flops=E, slabs=slabs,
            rows_capacity=cfg.bucket_capacity(slab_rows, enabled=bucket),
            nnza_capacity=cfg.bucket_capacity(slab_nnz or 1,
                                              enabled=bucket),
            total_out_capacity=cfg.bucket_capacity(total_out or 1,
                                                   enabled=bucket))
    return SpGEMMPlan(
        expansion_capacity=cfg.bucket_capacity(E, enabled=bucket),
        out_capacity=cfg.bucket_capacity(out_bound or 1, enabled=bucket),
        flops=E)


from ia_spgemm_tpu.utils.scans import (  # noqa: E402
    entry_rows,
    segment_broadcast as _segment_broadcast,
)

# Back-compat alias (used by parallel/distributed.py).
_entry_rows_from_row_ptr = entry_rows


def _packed_gather2(x_int: jax.Array, x_f: jax.Array,
                    idx: jax.Array):
    """Gather (x_int[idx], x_f[idx]) as ONE gather when dtypes allow packing
    (f32/i32); falls back to two gathers otherwise (fp64 path).

    Packing must happen in the INT domain: bitcasting arbitrary int32 to
    float32 creates NaN payloads that a float data path may canonicalize;
    int32 lanes move bit-exactly."""
    if x_f.dtype == jnp.float32:
        packed = jnp.stack(
            [x_int, jax.lax.bitcast_convert_type(x_f, jnp.int32)], axis=1)
        g = packed[idx]
        return g[:, 0], jax.lax.bitcast_convert_type(g[:, 1], jnp.float32)
    return x_int[idx], x_f[idx]


def _delta_broadcast(cols, positions, out_size: int):
    """Broadcast per-segment constants to every covered position, exactly,
    with NO gathers: scatter-ADD each entry's wraparound int32 delta
    (cols[t] - cols[t-1]) at its segment start, then cumsum.

    The telescoping sum reproduces cols[t] bit-exactly at every position
    covered by segment t — int32 addition is modular, so overflow (and
    float32 payloads carried as bitcast lanes) cancels exactly. Entries of
    zero length share a start position with the next entry; their deltas
    accumulate there and still telescope. This replaces per-element
    `x[t]` gathers with one entry-sized scatter plus cumsums.

    cols: (nnzA_cap, C) int32 per-entry values; positions: (nnzA_cap,)
    non-decreasing segment starts (== out_size for entries past the end).
    Positions at/after out_size fall into a dropped tail row.
    """
    nnz_cap = cols.shape[0]
    first = cols[:1]
    deltas = jnp.concatenate([first, cols[1:] - cols[:-1]], axis=0)
    pos = jnp.minimum(positions, out_size)
    buf = jnp.zeros((out_size + 1, cols.shape[1]), jnp.int32)
    buf = buf.at[pos].add(deltas, mode="drop")
    return jnp.cumsum(buf[:out_size], axis=0)


def _expand_factors(a_row, a_col_local, a_val, ent_active,
                    b_row_ptr, b_col, b_val, *, e_cap: int):
    """Numeric expand: the factors of every intermediate product.

    a_row/a_col_local/a_val: (nnzA_cap,) per stored A entry — row, LOCAL
    B-row index (already clipped into [0, len(b_row_ptr)-2]), value;
    ent_active masks which entries participate. a_row must be
    non-decreasing over active entries. Returns (i, j, a, b, valid)
    padded to e_cap, products in A-entry order: product e is
    a[e] * b[e] at (i[e], j[e]).
    """
    nnzA_cap = a_col_local.shape[0]
    ent = jnp.arange(nnzA_cap, dtype=jnp.int32)

    b_start = b_row_ptr[a_col_local]
    b_len = jnp.where(ent_active, b_row_ptr[a_col_local + 1] - b_start, 0)
    offs_end = jnp.cumsum(b_len, dtype=jnp.int32)
    E = offs_end[-1] if nnzA_cap else jnp.int32(0)
    offs_start = offs_end - b_len

    e = jnp.arange(e_cap, dtype=jnp.int32)
    valid = e < E
    if a_val.dtype == jnp.float32:
        # Per-segment constants [row, value-bits, b_start - offs_start]
        # broadcast by scatter-delta + cumsum (no gathers).
        cols = jnp.stack(
            [a_row, jax.lax.bitcast_convert_type(a_val, jnp.int32),
             b_start - offs_start], axis=1)
        bcast = _delta_broadcast(cols, offs_start, e_cap)
        i = bcast[:, 0]
        av_t = jax.lax.bitcast_convert_type(bcast[:, 1], jnp.float32)
        bpos = bcast[:, 2] + e
    else:
        # non-f32 (fp64 path): per-element gathers at the covering
        # segment t (scatter-max + cummax lookup).
        active = b_len > 0
        t = _segment_broadcast(ent + 1, offs_start, active, e_cap,
                               jnp.int32(0)) - 1
        t = jnp.clip(t, 0, nnzA_cap - 1)
        i = a_row[t]
        av_t = a_val[t]
        bpos = b_start[t] + (e - offs_start[t])
    bpos = jnp.clip(bpos, 0, b_col.shape[0] - 1)
    j, bv = _packed_gather2(b_col, b_val, bpos)
    return i, j, av_t, bv, valid


def _expand_products(a_row, a_col_local, a_val, ent_active,
                     b_row_ptr, b_col, b_val, *, e_cap: int):
    """Numeric expand: materialize intermediate products (i, j, a*b),
    see _expand_factors. Returns (i, j, v, valid)."""
    i, j, av, bv, valid = _expand_factors(
        a_row, a_col_local, a_val, ent_active, b_row_ptr, b_col, b_val,
        e_cap=e_cap)
    val_dtype = jnp.result_type(a_val.dtype, b_val.dtype)
    v = jnp.where(valid, av.astype(val_dtype) * bv.astype(val_dtype), 0)
    return i, j, v, valid


def _sort_compress(i, j, v, valid, *, out_cap: int, m: int, n: int):
    """Sort products by (i, j) and compress duplicates.

    Returns (row_ptr, col_ind, values, nnz) of the compressed result,
    padded to out_cap (cols past nnz get sentinel n, values 0).
    """
    e_cap = v.shape[0]
    val_dtype = v.dtype
    if out_cap > e_cap:
        # tiny problems: the expansion can be smaller than the bucketed
        # output capacity; pad so the [:out_cap] compaction slices hold
        pad = out_cap - e_cap
        i = jnp.pad(i, (0, pad))
        j = jnp.pad(j, (0, pad))
        v = jnp.pad(v, (0, pad))
        valid = jnp.pad(valid, (0, pad))
        e_cap = out_cap

    # ---- sort by (i, j): fused int32 key when m*n fits, else 2-key ----
    fused = (m + 1) * (n + 1) < 2**31
    if fused:
        key = jnp.where(valid, i * n + j, jnp.int32(m * n))
        key_s, v_s = jax.lax.sort((key, v), num_keys=1)
        valid_s = key_s < m * n
    else:
        i_sk = jnp.where(valid, i, m)
        j_sk = jnp.where(valid, j, n)
        i_s2, j_s2, v_s = jax.lax.sort((i_sk, j_sk, v), num_keys=2)
        key_s = None
        valid_s = i_s2 < m

    # ---- compress: run boundaries + segmented scan + compaction sort ----
    if fused:
        prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), key_s[:-1]])
        nxt = jnp.concatenate([key_s[1:], jnp.full(1, -1, jnp.int32)])
        head = valid_s & (key_s != prev)
        is_last = valid_s & (key_s != nxt)
    else:
        pi = jnp.concatenate([jnp.full(1, -1, jnp.int32), i_s2[:-1]])
        pj = jnp.concatenate([jnp.full(1, -1, jnp.int32), j_s2[:-1]])
        ni = jnp.concatenate([i_s2[1:], jnp.full(1, -1, jnp.int32)])
        nj = jnp.concatenate([j_s2[1:], jnp.full(1, -1, jnp.int32)])
        head = valid_s & ((i_s2 != pi) | (j_s2 != pj))
        is_last = valid_s & ((i_s2 != ni) | (j_s2 != nj))

    seg = jnp.cumsum(head, dtype=jnp.int32) - 1
    nnz_c = jnp.sum(head, dtype=jnp.int32)

    # values: segmented inclusive scan (prefix sums that RESET at run
    # heads). Unlike a global cumsum-difference (whose error scales with
    # the global running sum — measured 27x relative error in f32), each
    # run is tree-summed in isolation, matching segment_sum's accuracy
    # without a scatter.
    if val_dtype == jnp.float64:
        # fp64 path: keep segment_sum's summation order (the golden tests
        # assert 1e-12 absolute agreement with scipy).
        sums = jax.ops.segment_sum(
            v_s, jnp.clip(seg, 0, e_cap - 1), num_segments=e_cap,
            indices_are_sorted=True)
        run_pref = sums[jnp.clip(seg, 0, e_cap - 1)]
    else:
        (run_pref,) = segmented_scan((v_s[None],), head[None])
        run_pref = run_pref[0]

    # compaction: one more sort moves each run's LAST element (carrying the
    # completed run sum) to position seg — cheaper than scatters or
    # index-gathers at this size.
    key2 = jnp.where(is_last, seg, _INT32_MAX)
    seg_ids = jnp.arange(out_cap, dtype=jnp.int32)
    seg_valid = seg_ids < nnz_c
    if fused:
        _, key_c, val_c = jax.lax.sort((key2, key_s, run_pref), num_keys=1)
        key_c = key_c[:out_cap]
        val_c = val_c[:out_cap]
        rows_c = key_c // n
        cols_c = key_c - rows_c * n
    else:
        _, rows_c, cols_c, val_c = jax.lax.sort(
            (key2, i_s2, j_s2, run_pref), num_keys=1)
        rows_c = rows_c[:out_cap]
        cols_c = cols_c[:out_cap]
        val_c = val_c[:out_cap]
    c_val = jnp.where(seg_valid, val_c, 0).astype(val_dtype)
    c_col = jnp.where(seg_valid, cols_c, n).astype(jnp.int32)
    rows_m = jnp.where(seg_valid, rows_c, m).astype(jnp.int32)

    row_ptr = jnp.searchsorted(
        rows_m, jnp.arange(m + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return row_ptr, c_col, c_val, nnz_c


@functools.partial(
    jax.jit,
    static_argnames=("e_cap", "out_cap", "m", "n", "k"))
def _esc_core(a_row, a_col, a_val, a_nnz,
              b_row_ptr, b_col, b_val,
              *, e_cap: int, out_cap: int, m: int, k: int, n: int):
    """Format-agnostic ESC core over A's entry list: expand then
    sort-compress. Returns (row_ptr, col_ind, values, nnz) of C = A @ B,
    padded to out_cap."""
    nnzA_cap = a_col.shape[0]
    ent_valid = jnp.arange(nnzA_cap, dtype=jnp.int32) < a_nnz
    a_col_c = jnp.clip(a_col, 0, k - 1)
    i, j, v, valid = _expand_products(
        a_row, a_col_c, a_val, ent_valid, b_row_ptr, b_col, b_val,
        e_cap=e_cap)
    return _sort_compress(i, j, v, valid, out_cap=out_cap, m=m, n=n)


@functools.partial(jax.jit, static_argnames=("rows_cap", "nnza_cap"))
def _slab_inputs(row_ptr, col_ind, values, *, r0, s0, s1,
                 rows_cap: int, nnza_cap: int):
    """Slice one row slab of a CSR into fixed-capacity (rebased) arrays so
    every slab reuses ONE compiled ESC core. Tail rows/entries are padded
    empty."""
    m1 = row_ptr.shape[0] - 1
    rp = jax.lax.dynamic_slice(
        jnp.pad(row_ptr, (0, rows_cap)), (r0,), (rows_cap + 1,))
    rp = jnp.clip(rp - s0, 0, s1 - s0)
    col = jax.lax.dynamic_slice(
        jnp.pad(col_ind, (0, nnza_cap), constant_values=m1), (s0,),
        (nnza_cap,))
    val = jax.lax.dynamic_slice(jnp.pad(values, (0, nnza_cap)), (s0,),
                                (nnza_cap,))
    return rp, col, val


@jax.jit
def _slab_write(col_out, val_out, rp_out, piece_col, piece_val, piece_rp,
                off, r0):
    """Assemble one slab's compressed piece into the (padded) global
    output at host-known offsets — device-side dynamic_update_slice, one
    compiled shape for every slab. Tail-row garbage in piece_rp is
    overwritten by the next slab's correct values; the buffers carry one
    slab of padding so no update ever clamps."""
    col_out = jax.lax.dynamic_update_slice(col_out, piece_col, (off,))
    val_out = jax.lax.dynamic_update_slice(val_out, piece_val, (off,))
    rp_out = jax.lax.dynamic_update_slice(
        rp_out, (piece_rp + off).astype(jnp.int32), (r0,))
    return col_out, val_out, rp_out


def _spgemm_csr_sliced(A: CSR, B: CSR, plan: SpGEMMPlan) -> CSR:
    """Workspace-sliced ESC: run the core per row slab and concatenate —
    the reference's sliced coo_spmm_helper loop
    (coo_dev/common_coo_dev.h:388-450). Slabs share one compiled shape;
    assembly stays on device (dynamic_update_slice at host-known
    offsets); only each slab's scalar nnz is read back."""
    m, n = A.nrows, B.ncols
    row_ptr_h = np.asarray(A.row_ptr, dtype=np.int64)
    total_cap = plan.total_out_capacity
    # one slab of padding so padded piece writes never clamp
    col_out = jnp.full((total_cap + plan.out_capacity,), n, jnp.int32)
    # pieces come back in result_type(A, B): mixed-dtype operands must
    # assemble at that dtype, like the unsliced path
    out_dtype = jnp.result_type(A.values.dtype, B.values.dtype)
    val_out = jnp.zeros((total_cap + plan.out_capacity,), out_dtype)
    rp_out = jnp.zeros((m + 1 + plan.rows_capacity,), jnp.int32)
    off = 0
    slabs = plan.slabs
    for i in range(len(slabs) - 1):
        r0, r1 = slabs[i], slabs[i + 1]
        s0, s1 = int(row_ptr_h[r0]), int(row_ptr_h[r1])
        rp, col, val = _slab_inputs(
            A.row_ptr, A.col_ind, A.values, r0=r0, s0=s0, s1=s1,
            rows_cap=plan.rows_capacity, nnza_cap=plan.nnza_capacity)
        a_row = entry_rows(rp, plan.nnza_capacity)
        prow, pcol, pval, pnnz = _esc_core(
            a_row, col, val, jnp.int32(s1 - s0),
            B.row_ptr, B.col_ind, B.values,
            e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
            m=plan.rows_capacity, k=A.ncols, n=n)
        col_out, val_out, rp_out = _slab_write(
            col_out, val_out, rp_out, pcol, pval, prow, off, r0)
        off += int(pnnz)
    rp_out = rp_out.at[m].set(off)
    return CSR(row_ptr=rp_out[:m + 1], col_ind=col_out[:total_cap],
               values=val_out[:total_cap], nnz=jnp.int32(off),
               shape=(m, n))


def spgemm_csr(A: CSR, B: CSR, plan: SpGEMMPlan | None = None,
               engine: str = "global") -> CSR:
    """C = A @ B with both operands CSR: the reference's CSR_MUL_CSR
    (csr/common_csr.h:85-193) as global-sort ESC. Expansions beyond the
    workspace run the sliced path (see plan_spgemm/_spgemm_csr_sliced).

    engine="global" (default): the global-sort/sliced path — exact CSR
    out, and the fp64 golden-summation-order oracle. engine="slab": the
    slab-packed engine (ops/slab.py) flattened through slab_to_csr;
    SlabCSR-capable consumers (harness, checksum/to_scipy users) call
    spgemm_csr_slab and keep the native output instead."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if engine == "slab":
        from ia_spgemm_tpu.ops import slab as slab_mod
        call = slab_mod.plan_slab_csr(A, B)
        if call is not None:
            return slab_mod.slab_to_csr(call(),
                                        out_cap=call.plan.out_cap)
    if plan is None:
        plan = plan_spgemm(A, B)
    if plan.slabs is not None:
        return _spgemm_csr_sliced(A, B, plan)
    row_ptr, col, val, nnz = _esc_core(
        entry_rows(A.row_ptr, A.capacity), A.col_ind, A.values, A.nnz,
        B.row_ptr, B.col_ind, B.values,
        e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
        m=A.nrows, k=A.ncols, n=B.ncols)
    return CSR(row_ptr=row_ptr, col_ind=col, values=val, nnz=nnz,
               shape=(A.nrows, B.ncols))


# Share of device memory each operand's padded ELL form may take on the
# tiled route (2^28 slots of col + f32 value on the CPU backend's fixed
# 16 GiB): beyond it the conversion itself would crowd the product grid.
TILED_ELL_FRACTION = 1 / 8


def tiled_ell_budget_elems() -> int:
    return cfg.memory_budget(TILED_ELL_FRACTION) // 8


def plan_csr_tiled(A: CSR, B: CSR, *, out_width: int | None = None):
    """Plan the tiled CSR route ONCE: ELL-convert on device, plan the
    width classes, and return a zero-argument runner producing a
    128-aligned BlockCSR — or None when the route is not viable
    (non-f32, an operand blows the ELL slot budget, or a row's products
    exceed the class planner's width/budget caps).

    The conversion + class planning here is the tiled analogue of
    plan_spgemm's symbolic phase: one-time setup amortized across calls,
    reported by the harness as trans time."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if (A.values.dtype != jnp.float32
            or B.values.dtype != jnp.float32):
        return None
    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.ops import bitonic
    ka = convert.plan_ell_width(A)
    kb = convert.plan_ell_width(B)
    budget = tiled_ell_budget_elems()
    if A.nrows * max(ka, 1) > budget or B.nrows * max(kb, 1) > budget:
        return None
    A_ell = convert.csr_to_ell(A, width=ka, check_guard=False)
    B_ell = convert.csr_to_ell(B, width=kb, check_guard=False)
    return bitonic.multiclass_planned(
        A_ell, B_ell, assemble="bcsr", out_width=out_width)


def spgemm_csr_tiled(A: CSR, B: CSR, *, out_width: int | None = None):
    """CSR-in width-class SpGEMM: each row's products sort at its own
    pow2 width in a batched row sort (ops/bitonic.py), emitting a
    128-aligned BlockCSR. Same expand-sort-compress contract as
    spgemm_csr, with per-row sorts in place of one global sort. Returns
    None when not viable — callers fall back to spgemm_csr."""
    call = plan_csr_tiled(A, B, out_width=out_width)
    return call() if call is not None else None


# The CSR engines spgemm_csr_auto can run, by name.
CSR_ENGINES = ("global", "tiled", "slab", "hybrid")

# Device-time model of the CSR engines, fitted on an NVIDIA H100 80GB
# HBM3 (power limit 400 W) at bench.build_matrix(m=2**19): 8.9M nnz,
# 1.515e8 products, steady-state wall per multiply:
#   global  398.8 ms / 1.515e8 products            -> 2.632 ns/product
#   tiled    28.06 ms / 2.434e8 padded class slots -> 0.1153 ns/slot
#   slab     26.01 ms / 2.013e8 padded slab slots  -> 0.1292 ns/slot
# Padded slots are what each engine sorts, so skew (pow2 class padding,
# slab-end padding, rows too long for a slab) moves the prediction.
_NS_PER_PRODUCT_GLOBAL = 2.632
_NS_PER_SLOT_TILED = 0.1153
_NS_PER_SLOT_SLAB = 0.1292


def predict_csr_route_ms(A: CSR, B: CSR):
    """Predict device time (ms) per viable CSR engine from host-side
    stats (the per-row product counts; no device work beyond them).
    Returns {route: predicted_ms} over the routes whose viability
    pre-checks pass; 'global' is always present."""
    from ia_spgemm_tpu.formats import convert
    from ia_spgemm_tpu.ops import bitonic
    from ia_spgemm_tpu.ops import slab as slab_mod
    from ia_spgemm_tpu.ops.flops import row_flops

    if int(A.nnz) == 0 or int(B.nnz) == 0:
        return {"global": 0.0}
    rf = row_flops(A, B)
    out = {"global": float(rf.sum()) * _NS_PER_PRODUCT_GLOBAL * 1e-6}
    if A.values.dtype != jnp.float32 or B.values.dtype != jnp.float32:
        return out    # the row-grid engines are f32-only

    budget = tiled_ell_budget_elems()
    if (A.nrows * max(convert.plan_ell_width(A), 1) <= budget
            and B.nrows * max(convert.plan_ell_width(B), 1) <= budget):
        plan, W = bitonic.plan_multiclass(rf)
        if plan.viable:
            slots = sum(cfg.bucket_capacity(int((W == w).sum())) * w
                        for w in plan.widths)
            out["tiled"] = slots * _NS_PER_SLOT_TILED * 1e-6

    heavy = rf > slab_mod.SLAB_MAX_WIDTH
    light = np.where(heavy, 0, rf)
    if light.any():
        t_light = slab_mod.padded_slots(
            light, slab_mod.slab_width(light.max())) \
            * _NS_PER_SLOT_SLAB * 1e-6
        if not heavy.any():
            out["slab"] = t_light
        else:
            out["hybrid"] = t_light + float(rf[heavy].sum()) \
                * _NS_PER_PRODUCT_GLOBAL * 1e-6
    return out


def plan_csr_engine(A: CSR, B: CSR, engine: str,
                    plan: SpGEMMPlan | None = None, bucket=True):
    """Plan one named CSR engine and return its zero-argument runner, or
    None when the engine is not viable for (A, B). 'global' is always
    viable. The runner returns CSR (global), BlockCSR (tiled), SlabCSR
    (slab) or HybridCSR (hybrid) — all satisfy the checksum/to_scipy
    result contract."""
    from ia_spgemm_tpu.ops import slab as slab_mod
    if engine == "global":
        esc_plan = plan if plan is not None \
            else plan_spgemm(A, B, bucket=bucket)
        return lambda: spgemm_csr(A, B, esc_plan)
    if engine == "tiled":
        return plan_csr_tiled(A, B)
    if engine == "slab":
        return slab_mod.plan_slab_csr(A, B)
    if engine == "hybrid":
        return slab_mod.plan_slab_hybrid(A, B)
    raise ValueError(f"unknown CSR engine {engine!r}; one of {CSR_ENGINES}")


def plan_csr_auto(A: CSR, B: CSR, plan: SpGEMMPlan | None = None,
                  bucket=True):
    """Plan the production CSR @ CSR route: predict each viable engine's
    device time (predict_csr_route_ms) and construct the cheapest one,
    falling through to the next candidate when a full planner declines
    (the cheap pre-checks are a superset, not a proof, of viability).
    Returns (route_name, zero-arg runner); plan_csr_engine runs one
    named engine."""
    pred = predict_csr_route_ms(A, B)
    for route in sorted(pred, key=pred.get):
        call = plan_csr_engine(A, B, route, plan, bucket)
        if call is not None:
            return route, call
    raise AssertionError("unreachable: 'global' is always viable")


def spgemm_csr_auto(A: CSR, B: CSR, plan: SpGEMMPlan | None = None):
    """Production CSR @ CSR entry point: the reference's CSR_MUL_CSR
    role (csr/common_csr.h:85-193), with the engine chosen by the card-
    fitted cost model (see plan_csr_auto). Returns CSR (global), BlockCSR
    (tiled), SlabCSR (slab) or HybridCSR (hybrid); all satisfy the
    checksum/to_scipy result contract."""
    _route, call = plan_csr_auto(A, B, plan)
    return call()


# ---------------------------------------------------------------------------
# Compensated (double-double) variant — fp64-grade accumulation from f32
# ---------------------------------------------------------------------------

def _ob(x):
    """Optimization barrier: XLA runs with allow_excess_precision, whose
    algebraic simplifier may cancel error-recovery sequences like
    (a + b) - b, and a fused a*b - c may contract into one FMA. Barriers
    pin the rounded intermediates."""
    return jax.lax.optimization_barrier(x)


def _two_sum(a_hi, a_lo, b_hi, b_lo):
    """Double-double addition (Knuth two-sum + renormalize): exact to
    ~2^-48 relative, using only f32 ops."""
    s = _ob(a_hi + b_hi)
    bp = _ob(s - a_hi)
    err = (a_hi - _ob(s - bp)) + (b_hi - bp)
    lo = err + a_lo + b_lo
    hi = _ob(s + lo)
    return hi, lo - (hi - s)


def _two_product(a, b):
    """Dekker two-product (no FMA needed): a*b = hi + lo exactly."""
    split = jnp.asarray(4097.0, a.dtype)  # 2^12 + 1 for f32
    a1 = _ob(a * split)
    ah = _ob(a1 - (a1 - a))
    al = a - ah
    b1 = _ob(b * split)
    bh = _ob(b1 - (b1 - b))
    bl = b - bh
    p = _ob(a * b)
    e = ((_ob(ah * bh) - p) + _ob(ah * bl) + _ob(al * bh)) + al * bl
    return p, e


@jax.jit
def dd_sum(hi, lo):
    """Exact-grade total of a double-double array ON DEVICE: pairwise
    folding under two-sum (log2(n) halving passes), returning a (hi, lo)
    scalar pair. Error matches a balanced-tree dd reduction (~2^-48
    relative) — the host only reads back 8 bytes."""
    n = hi.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        hi = jnp.pad(hi, (0, p - n))
        lo = jnp.pad(lo, (0, p - n))
    while p > 1:
        half = p // 2
        hi, lo = _two_sum(hi[:half], lo[:half], hi[half:], lo[half:])
        p = half
    return hi[0], lo[0]


def dd_add(left, right):
    """Double-double addition of (hi, lo) pairs, as a segmented_scan
    combiner."""
    return _two_sum(left[0], left[1], right[0], right[1])


@functools.partial(
    jax.jit, static_argnames=("e_cap", "out_cap", "m", "n", "k"))
def _esc_core_dd(a_row, a_col, a_val, a_nnz, b_row_ptr, b_col, b_val,
                 *, e_cap: int, out_cap: int, m: int, k: int, n: int):
    """ESC with double-double products and run sums: every intermediate
    product is an exact (hi, lo) pair (Dekker) and duplicate runs combine
    under two-sum, so the accumulated values carry ~2^-48 relative error —
    fp64-grade results from f32 arithmetic (one extra sort payload + ~10
    extra flops/element in the scan)."""
    nnzA_cap = a_col.shape[0]
    ent_valid = jnp.arange(nnzA_cap, dtype=jnp.int32) < a_nnz
    a_col_c = jnp.clip(a_col, 0, k - 1)
    # expand the FACTORS (not the rounded product): Dekker's two-product
    # keeps the exact (hi, lo) per intermediate product
    i, j, av_t, bv, valid = _expand_factors(
        a_row, a_col_c, a_val, ent_valid, b_row_ptr, b_col, b_val,
        e_cap=e_cap)
    hi, lo = _two_product(av_t, bv)
    hi = jnp.where(valid, hi, 0.0)
    lo = jnp.where(valid, lo, 0.0)

    if out_cap > e_cap:
        pad = out_cap - e_cap
        i = jnp.pad(i, (0, pad))
        j = jnp.pad(j, (0, pad))
        hi = jnp.pad(hi, (0, pad))
        lo = jnp.pad(lo, (0, pad))
        valid = jnp.pad(valid, (0, pad))

    key = jnp.where(valid, i * n + j, jnp.int32(m * n))
    key_s, hi_s, lo_s = jax.lax.sort((key, hi, lo), num_keys=1)
    valid_s = key_s < m * n
    prev = jnp.concatenate([jnp.full(1, -1, jnp.int32), key_s[:-1]])
    nxt = jnp.concatenate([key_s[1:], jnp.full(1, -1, jnp.int32)])
    head = valid_s & (key_s != prev)
    is_last = valid_s & (key_s != nxt)
    seg = jnp.cumsum(head, dtype=jnp.int32) - 1
    nnz_c = jnp.sum(head, dtype=jnp.int32)

    rhi, rlo = segmented_scan((hi_s[None], lo_s[None]), head[None],
                              add=dd_add)
    rhi, rlo = rhi[0], rlo[0]

    key2 = jnp.where(is_last, seg, _INT32_MAX)
    _, key_c, hi_c, lo_c = jax.lax.sort((key2, key_s, rhi, rlo),
                                        num_keys=1)
    key_c = key_c[:out_cap]
    hi_c = hi_c[:out_cap]
    lo_c = lo_c[:out_cap]
    seg_valid = jnp.arange(out_cap, dtype=jnp.int32) < nnz_c
    rows_c = key_c // n
    cols_c = key_c - rows_c * n
    c_hi = jnp.where(seg_valid, hi_c, 0.0)
    c_lo = jnp.where(seg_valid, lo_c, 0.0)
    c_col = jnp.where(seg_valid, cols_c, n).astype(jnp.int32)
    rows_m = jnp.where(seg_valid, rows_c, m).astype(jnp.int32)
    row_ptr = jnp.searchsorted(
        rows_m, jnp.arange(m + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    return row_ptr, c_col, c_hi, c_lo, nnz_c


def spgemm_csr_compensated(A: CSR, B: CSR,
                           plan: SpGEMMPlan | None = None,
                           engine: str = "auto"):
    """C = A @ B with double-double accumulation: f32 operands, fp64-grade
    sums (~2^-48 relative). The result stays ON DEVICE as a (values,
    values_lo) f32 pair — hi + lo is exact in float64; combine with
    values_f64()/to_scipy on the host or reduce with dd_sum on device
    (no O(nnz) transfer).

    engine: 'auto' runs the compensated SLAB pipeline when viable
    (two-value-lane row sort + two-sum compress, returning SlabCSR with
    values_lo) and the global-sort core otherwise; 'global' forces the
    CSR-returning global path. An explicitly provided sliced plan still
    raises — the global core does not slice.

    Requires the fused int32 key (m*n < 2^31) — covered by all reference
    workloads; larger products take the fp64 path instead.
    """
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    if (A.nrows + 1) * (B.ncols + 1) >= 2**31:
        raise ValueError("compensated path needs m*n < 2^31")
    if A.values.dtype != jnp.float32:
        raise ValueError("compensated path takes float32 operands")
    if plan is not None and plan.slabs is not None:
        # an explicitly sliced plan is a contract error regardless of
        # engine — the caller sized capacities per-slab
        raise ValueError(
            f"expansion {plan.flops} exceeds the single-slab workspace "
            "and the compensated path does not slice; raise "
            "workspace_elems in plan_spgemm or row-partition "
            "(ia_spgemm_tpu.parallel)")
    if engine == "auto":
        from ia_spgemm_tpu.ops import slab as slab_mod
        call = slab_mod.plan_slab_csr(A, B, dd=True)
        if call is not None:
            return call()
    if plan is None:
        plan = plan_spgemm(A, B)
    if plan.slabs is not None:
        # a sliced plan's capacities are PER-SLAB; running the whole
        # matrix against them would silently truncate the expansion
        raise ValueError(
            f"expansion {plan.flops} exceeds the single-slab workspace "
            "and the compensated path does not slice; raise "
            "workspace_elems in plan_spgemm or row-partition "
            "(ia_spgemm_tpu.parallel)")
    row_ptr, col, hi, lo, nnz = _esc_core_dd(
        entry_rows(A.row_ptr, A.capacity), A.col_ind, A.values, A.nnz,
        B.row_ptr, B.col_ind, B.values,
        e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
        m=A.nrows, k=A.ncols, n=B.ncols)
    return CSR(row_ptr=row_ptr, col_ind=col, values=hi, values_lo=lo,
               nnz=nnz, shape=(A.nrows, B.ncols))


def spgemm_coo(A: COO, B: COO, plan: SpGEMMPlan | None = None) -> COO:
    """C = A @ B with both operands COO. The reference's COO_MUL_COO uses
    linear probing into the output row (coo/common_coo.h:72-161); here the
    same products go through the ESC core using A's materialized row_ind."""
    from ia_spgemm_tpu.formats.convert import coo_to_csr, csr_to_coo
    if plan is None:
        plan = plan_spgemm(coo_to_csr(A), coo_to_csr(B))
    if plan.slabs is not None:
        # sliced plans carry PER-SLAB capacities; a single whole-matrix
        # core call would silently truncate — run the sliced CSR engine
        # and convert back instead
        C = _spgemm_csr_sliced(coo_to_csr(A), coo_to_csr(B), plan)
        return csr_to_coo(C)
    row_ptr, col, val, nnz = _esc_core(
        A.row_ind, A.col_ind, A.values, A.nnz,
        B.row_offset, B.col_ind, B.values,
        e_cap=plan.expansion_capacity, out_cap=plan.out_capacity,
        m=A.nrows, k=A.ncols, n=B.ncols)
    return csr_to_coo(CSR(row_ptr=row_ptr, col_ind=col, values=val, nnz=nnz,
                          shape=(A.nrows, B.ncols)))
