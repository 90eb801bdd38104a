"""A made program whose kernel-signature buckets reach every source-ref
level (0-2) with every most band-plan heads per sink group (0-3), so
every instantiation of kernel B1 (csrc/sampled_hist.cu's
sampled_hist_kernel<LV, NHMAX>, NHMAX 1 or 3) and every head count
inside it, which the registry's models do not: array S
has a three-head group (a stride-2 innermost term ends in a check), T a
two-head group, U constant refs (no head), V one head over an interval,
and A a window terminal over a descending level. Written against either
package's IR, so the JAX-free card tests can use it too.

`made_tri_program` is its triangular twin (the instantiations
sampled_hist_kernel<LV, NHMAX, true>): the same arrays over a nest whose
level 1 ascends with the parallel value (j <= i) and whose level 2
shrinks from a start that moves with it, reaching zero trips, with
post-slot refs after a triangular subloop at levels 0 and 1."""

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


# trip, start, trip coefficient, start coefficient (unit steps: the
# triangular closed form needs them)
_TRI_LOOPS = ((6, 0, 0, 0), (1, 0, 1, 0), (5, 1, -1, 1))
# name, array, level, coeffs, const, share threshold, slot
_TRI_REFS = (
    ("S0", "S", 2, (40, 8, 2), 0, None, "pre"),
    ("S1", "S", 2, (40, 8, 2), 1, None, "pre"),
    ("S2", "S", 2, (40, 8, 2), 0, 9, "pre"),
    ("S3", "S", 0, (40,), 0, None, "post"),
    ("S4", "S", 1, (40, 8), 0, None, "post"),
    ("T0", "T", 2, (40, 8, 1), 0, None, "pre"),
    ("T1", "T", 1, (40, 8), 0, None, "pre"),
    ("T2", "T", 0, (40,), 0, None, "pre"),
    ("U0", "U", 2, (0, 0, 0), 0, None, "pre"),
    ("U1", "U", 1, (0, 0), 0, None, "post"),
    ("U2", "U", 0, (0,), 0, None, "post"),
    ("V0", "V", 2, (40, 0, 1), 0, None, "pre"),
    ("A0", "A", 1, (5, 1), 0, None, "pre"),
    ("A1", "A", 0, (5,), 0, None, "post"),
)


def made_tri_program(Loop, ParallelNest, Program, Ref):
    refs = tuple(
        Ref(n, a, level=lv, coeffs=c, const=k, slot=sl) if thr is None
        else Ref(n, a, level=lv, coeffs=c, const=k, slot=sl,
                 share_threshold=thr)
        for n, a, lv, c, k, thr, sl in _TRI_REFS
    )
    loops = tuple(Loop(t, start=s, trip_coeff=tc, start_coeff=sc)
                  for t, s, tc, sc in _TRI_LOOPS)
    return Program(name="b1-tri-instantiations",
                   nests=(ParallelNest(loops=loops, refs=refs),))


def tri_step2_program(Loop, ParallelNest, Program, Ref):
    """A triangular nest with a step of 2, which the closed-form next-use
    does not cover (the JAX package's tests/test_sampled.py program)."""
    return Program(name="tri-step2", nests=(ParallelNest(
        loops=(Loop(8, step=2), Loop(trip=1, trip_coeff=1)),
        refs=(Ref("A0", "A", level=1, coeffs=(8, 1)),),
    ),))


# Nests past kernel B1's old descriptor limits (a parameter block of
# MAX_DESC = 2048 words, sink groups of MAX_MEMBERS = 8 refs): many refs
# of one array in a 3-deep nest, which the frontend accepts up to its
# MAX_REFS_PER_NEST = 64.
def distinct_maps_program(Loop, ParallelNest, Program, Ref, n: int,
                          n_refs: int = 64):
    """`n_refs` refs of array A at level 2, each of its own flat map
    (constants 0..n_refs-1, the odd ones along j, the even ones along k):
    one sink group per ref, a descriptor of about 2,460 words at 64."""
    refs = tuple(
        Ref(f"A{r}", "A", level=2,
            coeffs=(n, 1, 0) if r % 2 else (n, 0, 1), const=r)
        for r in range(n_refs)
    )
    return Program(name=f"distinct-maps-{n_refs}", nests=(ParallelNest(
        loops=(Loop(n), Loop(n), Loop(n)), refs=refs),))


def one_map_program(Loop, ParallelNest, Program, Ref, n: int, n_refs: int,
                    tri: bool = False):
    """`n_refs` refs of array C with one flat map, C[i][k] at level 2, and
    a share ref of array B: one sink group of `n_refs` members. `tri`
    makes the innermost level triangular (k <= i), as syrk-tri's."""
    inner = Loop(trip=1, trip_coeff=1) if tri else Loop(n)
    refs = tuple(Ref(f"C{r}", "C", level=2, coeffs=(n, 0, 1))
                 for r in range(n_refs))
    refs += (Ref("B0", "B", level=2, coeffs=(0, 1, n),
                 share_threshold=(n + 1) * n + 1),)
    name = f"one-map-{n_refs}" + ("-tri" if tri else "")
    return Program(name=name, nests=(ParallelNest(
        loops=(Loop(n), Loop(n), inner), refs=refs),))


def past_limits_programs(Loop, ParallelNest, Program, Ref, n: int) -> list:
    """The made nests past both old limits: 64 distinct maps; 9 and 17
    members of one map; a triangular nest of 9 members."""
    return [distinct_maps_program(Loop, ParallelNest, Program, Ref, n),
            one_map_program(Loop, ParallelNest, Program, Ref, n, 9),
            one_map_program(Loop, ParallelNest, Program, Ref, n, 17),
            one_map_program(Loop, ParallelNest, Program, Ref, n, 9,
                            tri=True)]
