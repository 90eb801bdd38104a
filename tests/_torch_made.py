"""A made program whose kernel-signature buckets reach every source-ref
level (0-2) with every most band-plan heads per sink group (0-3), so
every instantiation of kernel B1 (csrc/sampled_hist.cu's
sampled_hist_kernel<LV, NHMAX>, NHMAX 1 or 3) and every head count
inside it, which the registry's models do not: array S
has a three-head group (a stride-2 innermost term ends in a check), T a
two-head group, U constant refs (no head), V one head over an interval,
and A a window terminal over a descending level. Written against either
package's IR, so the JAX-free card tests can use it too."""

_LOOPS = ((6, 0, 1), (5, 4, -1), (4, 0, 1))  # trip, start, step
# name, array, level, coeffs, const, share threshold
_REFS = (
    ("S0", "S", 2, (40, 8, 2), 0, None), ("S1", "S", 2, (40, 8, 2), 1, None),
    ("S2", "S", 2, (40, 8, 2), 0, 9), ("S3", "S", 0, (40,), 0, None),
    ("S4", "S", 1, (40, 8), 0, None),
    ("T0", "T", 2, (40, 8, 1), 0, None), ("T1", "T", 1, (40, 8), 0, None),
    ("T2", "T", 0, (40,), 0, None),
    ("U0", "U", 2, (0, 0, 0), 0, None), ("U1", "U", 1, (0, 0), 0, None),
    ("U2", "U", 0, (0,), 0, None),
    ("V0", "V", 2, (40, 0, 1), 0, None),
    ("A0", "A", 1, (5, 1), 0, None), ("A1", "A", 0, (5,), 0, None),
)


def made_program(Loop, ParallelNest, Program, Ref):
    refs = tuple(
        Ref(n, a, level=lv, coeffs=c, const=k) if thr is None
        else Ref(n, a, level=lv, coeffs=c, const=k, share_threshold=thr)
        for n, a, lv, c, k, thr in _REFS
    )
    loops = tuple(Loop(t, start=s, step=st) for t, s, st in _LOOPS)
    return Program(name="b1-instantiations",
                   nests=(ParallelNest(loops=loops, refs=refs),))
