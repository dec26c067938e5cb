"""Input-aware autotuning: features + density images -> MatNet -> algorithm.

The end-to-end selection pipeline of the reference driver
(main.cpp:512-704): extract the 26-feature vector and both 128x128 density
images, run MatNet, map the predicted class to an algorithm.

Class menu mapping: the shipped CPU weights predict over
(MKL, CSR, DIA, ELL, COO) (README.md:5-8). In this framework the vendor
black-box slot is the XLA dense matmul path for small matrices and the
scipy host baseline during benchmarking; retrained ("upcycled") weights
label classes directly with our algorithm names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ia_spgemm_tpu.formats import convert
from ia_spgemm_tpu.formats.types import CSR
from ia_spgemm_tpu.models import matnet, weights
from ia_spgemm_tpu.ops import density, features

# Reference CPU class index -> our algorithm menu.
# Class 0 is the vendor baseline (MKL there, scipy-host/dense matmul here).
CPU_CLASS_TO_ALGORITHM = ("baseline", "csr", "dia", "ell", "coo")
# Reference GPU classes (main.cu:539-544): CUSP (library ESC over COO) ->
# our COO-ESC; cuSPARSE (vendor CSR) -> our CSR-ESC; NSPARSE (row-class
# hash kernels, unimplemented in the reference) -> our bitonic slot.
GPU_CLASS_TO_ALGORITHM = ("coo", "csr", "bitonic")


@dataclasses.dataclass
class AutotuneResult:
    algorithm: str
    class_index: int
    logits: np.ndarray
    feature_vector: np.ndarray


def select_algorithm(A: CSR, B: CSR,
                     params=None,
                     arch: Optional[dict] = None,
                     class_menu: Optional[Sequence[str]] = None,
                     weight_name: str = "Intel") -> AutotuneResult:
    """Pick the predicted-fastest algorithm for C = A @ B.

    weight_name may be a shipped set (Intel/Amd/P100, reference parity)
    or a path to an upcycled .npz; upcycled files carry their own class
    menu."""
    if params is None:
        if weight_name.endswith(".npz"):
            params, menu = weights.load_params_npz(weight_name,
                                                   with_menu=True)
            arch = weights.infer_arch(params)
            if class_menu is None and menu is not None:
                class_menu = menu
        else:
            params, arch = weights.import_reference_weights(weight_name)
    if arch is None:
        arch = weights.infer_arch(params)
    if class_menu is None:
        class_menu = (GPU_CLASS_TO_ALGORITHM
                      if arch.get("num_classes") == 3
                      else CPU_CLASS_TO_ALGORITHM)

    fv = np.asarray(features.feature_vector(A, B), dtype=np.float64)
    nf = arch["num_features"]
    fv_in = fv[:nf] if len(fv) >= nf else np.pad(fv, (0, nf - len(fv)))

    img1 = np.asarray(density.density_image_normalized(A))
    img2 = np.asarray(density.density_image_normalized(B))

    logits = np.asarray(matnet.predict_logits(
        params, img1, img2, fv_in,
        num_classes=arch["num_classes"], num_features=nf))
    cls = int(np.argmax(logits))
    algo = class_menu[cls] if cls < len(class_menu) else "csr"
    return AutotuneResult(algorithm=algo, class_index=cls, logits=logits,
                          feature_vector=fv)


def spgemm_auto(A: CSR, B: CSR, **kwargs):
    """Autotuned SpGEMM: select, then run. Returns (C_as_csr, AutotuneResult).

    Viability guards still apply: if MatNet picks a format the size guard
    rejects (the reference would then simply fail that algorithm), we fall
    back to the CSR ESC path.
    """
    from ia_spgemm_tpu.ops import dense as dense_ops
    from ia_spgemm_tpu.ops import dia as dia_ops
    from ia_spgemm_tpu.ops import ell as ell_ops
    from ia_spgemm_tpu.ops import esc

    sel = select_algorithm(A, B, **kwargs)
    algo = sel.algorithm
    if algo == "dia":
        Ad, Bd = convert.csr_to_dia(A), convert.csr_to_dia(B)
        if (Ad is not None and Bd is not None
                and dia_ops.dia_compute_viable(
                    int(Ad.offsets.shape[0]), int(Bd.offsets.shape[0]),
                    A.nrows)):
            C = dia_ops.spgemm_dia(Ad, Bd)
            return convert.dia_to_csr(C), sel
        algo = "csr"
    if algo == "ell":
        Ae, Be = convert.csr_to_ell(A), convert.csr_to_ell(B)
        if Ae is not None and Be is not None:
            # the flat row grid when viable; width classes extend
            # viability to skewed rows; row-local ELL covers the rest
            from ia_spgemm_tpu.ops import bitonic as bt_ops
            plan = bt_ops.plan_bitonic(Ae, Be)
            if plan.viable:
                C = bt_ops.spgemm_bitonic(Ae, Be, plan)
            else:
                # skewed rows: width classes with block-aligned CSR out
                C = bt_ops.spgemm_bitonic_multiclass(Ae, Be,
                                                     assemble="bcsr")
            if C is None:
                C = ell_ops.spgemm_ell(Ae, Be)
            return _as_csr(C), sel
        algo = "csr"
    if algo == "coo":
        C = esc.spgemm_coo(convert.csr_to_coo(A), convert.csr_to_coo(B))
        return convert.coo_to_csr(C), sel
    if algo == "bitonic":
        # upcycled menus name the row-grid engine directly
        from ia_spgemm_tpu.ops import bitonic as bt_ops
        Ae = convert.csr_to_ell(A, check_guard=False)
        Be = convert.csr_to_ell(B, check_guard=False)
        plan = bt_ops.plan_bitonic(Ae, Be)
        C = (bt_ops.spgemm_bitonic(Ae, Be, plan) if plan.viable
             else bt_ops.spgemm_bitonic_multiclass(Ae, Be,
                                                   assemble="bcsr"))
        if C is not None:
            return _as_csr(C), sel
        algo = "csr"
    if algo == "esc":
        # the ESC-engine class. spgemm_auto's contract is exact flat
        # CSR, and to a FLAT result the global sort is the faster
        # engine (the slab engine's native SlabCSR is 17x quicker but
        # its flattening scatter costs more than the whole global sort
        # — see esc.spgemm_csr engine docs); SlabCSR-capable consumers
        # should call ops.slab.spgemm_csr_slab directly. A
        # workspace-overflow ValueError falls back like any rejected
        # pick.
        try:
            return esc.spgemm_csr(A, B, esc.plan_spgemm(A, B)), sel
        except ValueError:
            algo = "csr"
    if algo == "dense_row":
        from ia_spgemm_tpu import config as _cfg
        from ia_spgemm_tpu.ops import dense_row as dr_ops
        # the same viability gates the harness applies (harness.py
        # dense_row branch): B + C densify (memory budget) and A must be
        # ELL-viable — a mispredicted pick falls back to csr instead of
        # running out of memory
        vb = np.dtype(A.values.dtype).itemsize
        dense_elems = B.nrows * B.ncols + A.nrows * B.ncols
        ka = convert.plan_ell_width(A)
        if (dense_elems * vb <= _cfg.DEFAULT_CONFIG.dense_budget()
                and convert.ell_viable(A.nrows, int(A.nnz), ka)):
            Ae = convert.csr_to_ell(A, width=ka, check_guard=False)
            C = dr_ops.spgemm_dense_row(Ae, convert.csr_to_dense(B),
                                        config=_cfg.DEFAULT_CONFIG)
            return convert.dense_to_csr(C), sel
        algo = "csr"
    if algo == "serve":
        # bf16-value serving lane (documented bound: per-product rel
        # error <= 2^-9, f32 accumulation)
        from ia_spgemm_tpu.ops import bitonic as bt_ops
        Ae = convert.csr_to_ell(A, check_guard=False)
        Be = convert.csr_to_ell(B, check_guard=False)
        plan = bt_ops.plan_bitonic(Ae, Be)
        if plan.viable:
            try:
                C = bt_ops.spgemm_bitonic(Ae, Be, plan,
                                          value_mode="bf16")
                return _as_csr(C), sel
            except ValueError:
                pass
        algo = "csr"
    if algo == "compensated":
        try:
            return _as_csr(esc.spgemm_csr_compensated(A, B)), sel
        except ValueError:
            algo = "csr"
    if algo == "baseline" and A.nrows * B.ncols <= 4 * 1024 * 1024:
        C = dense_ops.spgemm_dense(A, B)
        return convert.dense_to_csr(C), sel
    return _as_csr(esc.spgemm_csr_auto(A, B)), sel


def _as_csr(C):
    """spgemm_auto's contract is an exact CSR result; the tiled routes
    return BlockCSR (128-aligned) and the slab engine SlabCSR — both
    convert with one flat scatter."""
    from ia_spgemm_tpu.formats.types import BlockCSR, SlabCSR
    from ia_spgemm_tpu.ops import slab as slab_mod
    if isinstance(C, BlockCSR):
        return convert.bcsr_to_csr(C)
    if isinstance(C, SlabCSR):
        return slab_mod.slab_to_csr(C)
    if isinstance(C, slab_mod.HybridCSR):
        # disjoint-row light/heavy parts; merge through the scipy host
        # path (consumers that can take the native HybridCSR should —
        # this coercion exists only for the exact-CSR contract here)
        from ia_spgemm_tpu.formats.types import CSR as _CSR
        return _CSR.from_scipy(C.to_scipy())
    if hasattr(C, "max_nnz_per_row"):        # ELL
        return convert.ell_to_csr(C)
    return C
