"""Distance measures for multisequence comparison — the port of
``fastkmer_tpu.multiseq.distances``.

Python re-design of the reference's Java plug-in contract
(``DistanceMeasure``, src/main/java/multiseq/DistanceMeasure.java:10-91,
implementations SquaredEuclidean.java / KLDLog2.java / KLDLogN.java).  The
contract is preserved (init / partial / operator / finalize / symmetry /
name / compatibility + the static count normalization helper) but the
partial-distance computation is *vectorized*: ``partial`` takes numpy
arrays of count pairs, because the pipeline accumulates distances over
whole unique-(k-mer, sequence) tables, not one scalar at a time.
``partial`` and ``bilinear_terms`` take numpy arrays; ``bilinear_row_terms``
(the device Gram path) takes and returns torch tensors.

Per the reference semantics, partials are computed on RAW per-k-mer counts
(Parameters(c1, c2) ints, SparkMultiSequenceKmerCounter.scala:479-481), a
k-mer absent from both sequences contributes nothing, and for KLD a zero on
either side contributes 0 (DKL guard, KLDLog2.java).
"""

from __future__ import annotations

import numpy as np


class DistanceMeasure:
    """Contract mirror of multiseq/DistanceMeasure.java:10-91."""

    name = "multisequence.DistanceMeasure"
    symmetric = True
    internal_product = False
    # distanceOperator kind (DistanceMeasure.java:16-40 allows sum OR
    # product plug-ins; hasInternalProduct):
    #   "sum"     — acc + cur, init 0.  Unlocks the bilinear/Gram fast
    #               paths and the O(U*S) generic sweep.
    #   "product" — acc * cur, init 1 (a plug-in should also override
    #               init_distance/operator to match).  Accumulated by the
    #               operator-generic fold in accumulate_distances:
    #               partial(0, 0) contributes to EVERY pair for every
    #               distinct k-mer, exactly like the reference merge loop
    #               (SparkMultiSequenceKmerCounter.scala:474-482).
    #   anything else — an ordered left fold applying ``operator`` per
    #               distinct k-mer (slowest, fully general).
    operator_kind = "sum"

    def init_distance(self) -> float:
        return 0.0

    def partial(self, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
        """Vectorized computePartialDistance over count-pair arrays.
        Sum measures must satisfy partial(0, 0) == 0 (the sweep identity
        depends on it); non-sum measures carry no such constraint — their
        fold evaluates every (group, pair) cell."""
        raise NotImplementedError

    def operator(self, acc, cur):
        """distanceOperator — override together with ``operator_kind``
        (and ``init_distance``) for non-additive plug-ins."""
        return acc + cur

    def bilinear_terms(self, C: np.ndarray):
        """Optional matmul fast path for the pairwise accumulation.

        ``C`` is a dense [groups, S] float64 count block (0 = k-mer absent
        from that sequence).  Return a list of (F, G) arrays shaped like
        ``C`` (and 0 at absent cells) such that the joint-pair correction

            h(x, y) = partial(x, y) - partial(x, 0) - partial(0, y)

        equals ``sum_r F[g, a] * G[g, b]`` for present cells — then the
        S x S pair sums reduce to blocked ``F.T @ G`` Gram products (BLAS
        on the host, matmuls on the card) instead of an O(U*S) pairwise sweep.
        Return None to use the generic fallback."""
        return None

    def bilinear_row_terms(self, c):
        """Row form of ``bilinear_terms`` for the DEVICE Gram path
        (multiseq.pipeline._pair_sums_from_device): given the float64 torch
        count column of PRESENT rows only (c > 0), return [(f(c), g(c)), ...]
        such that h(x, y) = sum_terms f(x) * g(y).  Elementwise torch ops
        only — the masked block matmul evaluates them per table row, never
        materializing the dense [groups, S] matrix.  Return None when no
        bilinear decomposition exists (the measure then runs host-side)."""
        return None

    def finalize(self, dist: float, num_el: int) -> float:
        return dist

    def is_compatible(self, pattern: str) -> bool:
        return True

    @staticmethod
    def normalized_values(c1, length1, c2, length2, k):
        """getNormalizedValues (DistanceMeasure.java:71-91): count/(len-k+1)."""
        den1, den2 = length1 - k + 1, length2 - k + 1
        v1 = c1 / den1 if (np.all(c1 != 0) and length1 and den1 > 0) else 0.0
        v2 = c2 / den2 if (np.all(c2 != 0) and length2 and den2 > 0) else 0.0
        return [v1, v2]


class SquaredEuclidean(DistanceMeasure):
    """(c1-c2)^2 summed over k-mers (SquaredEuclidean.java:19-27)."""

    name = "multisequence.SquaredEuclidean"
    symmetric = True

    def partial(self, c1, c2):
        d = np.asarray(c1, np.float64) - np.asarray(c2, np.float64)
        return d * d

    def bilinear_terms(self, C):
        # (x-y)^2 - x^2 - y^2 = -2xy
        return [(C, -2.0 * C)]

    def bilinear_row_terms(self, c):
        return [(c, -2.0 * c)]


class KLDLog2(DistanceMeasure):
    """c1 * log2(c1/c2), zero when either count is zero (KLDLog2.java DKL)."""

    name = "multisequence.KLDLog2"
    symmetric = False

    _log = staticmethod(np.log2)

    def partial(self, c1, c2):
        # broadcast first: callers mix scalar-shaped zeros with count arrays
        c1, c2 = np.broadcast_arrays(
            np.asarray(c1, np.float64), np.asarray(c2, np.float64)
        )
        both = (c1 != 0) & (c2 != 0)
        out = np.zeros(both.shape, np.float64)
        np.divide(c1, c2, out=out, where=both)
        res = np.zeros(both.shape, np.float64)
        res[both] = c1[both] * self._log(out[both])
        return res

    def bilinear_terms(self, C):
        # partial(x,0) = partial(0,y) = 0 (DKL guard), so
        # h = x*log(x)*[y>0] - x*log(y); absent cells contribute 0 on
        # both sides (C = 0 and log masked to 0).
        present = C > 0
        logC = np.zeros_like(C)
        self._log(C, out=logC, where=present)
        return [(C * logC, present.astype(np.float64)), (C, -logC)]

    def bilinear_row_terms(self, c):
        import torch

        log = torch.log2 if self._log is np.log2 else torch.log
        # rows exist only where count > 0, so no DKL zero-guard is needed
        lc = log(c)
        return [(c * lc, torch.ones_like(c)), (c, -lc)]


class KLDLogN(KLDLog2):
    """Natural-log variant (KLDLogN.java)."""

    name = "multisequence.KLDLogN"
    _log = staticmethod(np.log)


MEASURES = {m.name: m for m in (SquaredEuclidean(), KLDLog2(), KLDLogN())}
MEASURES.update({
    "squared_euclidean": MEASURES["multisequence.SquaredEuclidean"],
    "kld_log2": MEASURES["multisequence.KLDLog2"],
    "kld_logn": MEASURES["multisequence.KLDLogN"],
})


def get_measure(name_or_obj) -> DistanceMeasure:
    if isinstance(name_or_obj, DistanceMeasure):
        return name_or_obj
    return MEASURES[name_or_obj]
