"""Constraint simplification (O1/O2) with witness rebuild.

Python counterpart of constraint_list/src/constraint_simplification.rs:

* classify global constraints into constant-equalities / 2-signal
  equalities / linear / nonlinear (dag/src/map_to_constraint_list.rs:12-44);
* O1: union-find equality clusters solved with the reference's
  deterministic representative choice (forbidden signals stay; otherwise
  the minimum signal wins; size-1 clusters keep the smaller id,
  constraint_simplification.rs:126-196), then constant equalities;
* O2: per-cluster Gaussian elimination rounds (simplification_utils);
* substitution frames applied to the nonlinear set in DFS order
  (non_linear_utils.rs:6-31); nonlinears that become linear are kept;
* rebuild_witness: deleted + unused non-forbidden signals are removed and
  remaining ids compacted preserving order
  (constraint_simplification.rs:101-125).

Signal ids here are the global DFS ids produced by DAG.walk().
"""

from ..field.hostfield import HostField
from .algebra import CONST, Constraint, Substitution
from .dag import DAG


class SimplifiedSystem:
    def __init__(self, constraints, signal_map, n_labels, forbidden,
                 deleted, substitutions):
        self.constraints = constraints        # list of Constraint (old ids)
        self.signal_map = signal_map          # old id -> new id
        self.n_labels = n_labels
        self.forbidden = forbidden
        self.deleted = deleted
        self.substitutions = substitutions    # old id -> coeffs dict (old ids)

    def no_wires(self):
        return len(self.signal_map)

    def witness_as_vec(self):
        """new id -> old id (ConstraintList::get_witness_as_vec)."""
        out = [0] * len(self.signal_map)
        for old, new in self.signal_map.items():
            out[new] = old
        return out

    def remapped_rows(self):
        """Constraint rows over the compacted wire ids."""
        rows = []
        for c in self.constraints:
            rows.append(tuple(
                {
                    (CONST if k == CONST else self.signal_map[k]): v
                    for k, v in d.items()
                }
                for d in (c.a, c.b, c.c)
            ))
        return rows


def _take_signals_ordered(c: Constraint):
    return sorted(c.signals())


def _build_clusters(constraints):
    """Union-find over shared signals -> list of constraint lists."""
    parent = {}

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    sig_to_cluster = {}
    clusters = []  # cluster id -> list
    cluster_ids = []
    for c in constraints:
        if c.is_empty():
            continue
        cid = len(clusters)
        parent[cid] = cid
        clusters.append([c])
        cluster_ids.append(cid)
        for s in c.signals():
            prev = sig_to_cluster.get(s)
            sig_to_cluster[s] = cid
            if prev is not None:
                rp, rc = find(prev), find(cid)
                if rp != rc:
                    clusters[rc].extend(clusters[rp])
                    clusters[rp] = []
                    parent[rp] = rc
    return [cl for cl in clusters if cl]


def _eq_cluster_simplification(cluster, forbidden, hf):
    """(substitutions, kept constraints) for one equality cluster."""
    subs, cons = [], []
    if len(cluster) == 1:
        c = cluster[0]
        s0, s1 = _take_signals_ordered(c)
        if s0 in forbidden and s1 in forbidden:
            cons.append(c)
        elif s0 in forbidden:
            subs.append(Substitution(s1, {s0: 1}))
        elif s1 in forbidden:
            subs.append(Substitution(s0, {s1: 1}))
        else:
            l, r = (s0, s1) if s0 > s1 else (s1, s0)
            subs.append(Substitution(l, {r: 1}))
        return subs, cons
    remains, remove = set(), set()
    for c in cluster:
        for s in _take_signals_ordered(c):
            (remains if s in forbidden else remove).add(s)
    if remains:
        rh = min(remains)
        remains.discard(rh)
    else:
        rh = min(remove)
        remove.discard(rh)
    for s in sorted(remains):
        cons.append(Constraint({}, {}, {s: 1, rh: hf.p - 1}))
    for s in remove:
        subs.append(Substitution(s, {rh: 1}))
    return subs, cons


def _constant_eq_simplification(constraints, forbidden, hf):
    subs, cons = [], []
    for c in constraints:
        sigs = _take_signals_ordered(c)
        s = sigs[-1]
        if s in forbidden:
            cons.append(c)
        else:
            subs.append(Substitution.from_constraint(c, s, hf))
    return subs, cons


def _apply_frames(c: Constraint, frames, hf):
    changed = False
    for frame in frames:
        for s in list(c.signals()):
            sub = frame.get(s)
            if sub is not None:
                c.apply_substitution(Substitution(s, sub), hf)
                changed = True
    if changed:
        c.fixed(hf)
    return c


def _gauss_cluster(cluster, forbidden, hf):
    """Deterministic Gaussian elimination of one linear cluster
    (simplification_utils::full_simplification, simplified variant:
    always eliminate the largest non-forbidden signal of each
    constraint, smallest-first processing for determinism)."""
    subs = {}
    cons = []
    # normalize processing order for determinism
    work = sorted(cluster, key=lambda c: (_take_signals_ordered(c),
                                          sorted(c.c.items())))
    for c in work:
        c = Constraint({}, {}, dict(c.c))
        # apply accumulated substitutions
        for s in list(c.signals()):
            if s in subs:
                c.apply_substitution(Substitution(s, subs[s]), hf)
        c.fixed(hf)
        if c.is_empty():
            continue
        sigs = [s for s in _take_signals_ordered(c) if s not in forbidden]
        if not sigs:
            cons.append(c)
            continue
        # eliminate the largest eliminable signal
        target = sigs[-1]
        sub = Substitution.from_constraint(c, target, hf)
        # substitute into existing substitutions to keep them closed
        for k in list(subs.keys()):
            if target in subs[k]:
                coef = subs[k].pop(target)
                for s2, v2 in sub.coeffs.items():
                    nv = hf.add(subs[k].get(s2, 0), hf.mul(coef, v2))
                    if nv == 0:
                        subs[k].pop(s2, None)
                    else:
                        subs[k][s2] = nv
        subs[target] = sub.coeffs
    out_subs = [Substitution(k, v) for k, v in subs.items()]
    return out_subs, cons


def _gauss_cluster_new(cluster, forbidden, hf):
    """The reference's 'new' heuristics (substitution_process_4,
    simplification_utils.rs:156-186): signals occurring in exactly one
    constraint are substituted out first (treat_unique_constraint_4),
    then each constraint eliminates its LEAST-OCCURRING eligible signal
    (take_signal_4; ties to the larger id).  Occurrence counts are kept
    over the remaining constraint set.  Substitutions are kept closed
    incrementally, so the conflict-merge loop of the reference never
    triggers (equivalent result, same as _gauss_cluster)."""
    from collections import Counter

    occ = Counter()
    for c in cluster:
        for s in c.signals():
            occ[s] += 1
    work = sorted(cluster, key=lambda c: (_take_signals_ordered(c),
                                          sorted(c.c.items())))
    # unique-occurrence eliminables first, in deterministic order
    uniq_first, rest = [], []
    for c in work:
        if any(occ[s] == 1 and s not in forbidden for s in c.signals()):
            uniq_first.append(c)
        else:
            rest.append(c)
    subs = {}
    cons = []
    for c0 in uniq_first + rest:
        for s in c0.signals():
            occ[s] -= 1
        c = Constraint({}, {}, dict(c0.c))
        for s in list(c.signals()):
            if s in subs:
                c.apply_substitution(Substitution(s, subs[s]), hf)
        c.fixed(hf)
        if c.is_empty():
            continue
        sigs = [s for s in _take_signals_ordered(c) if s not in forbidden]
        if not sigs:
            cons.append(c)
            continue
        target = min(sigs, key=lambda s: (occ[s], -s))
        sub = Substitution.from_constraint(c, target, hf)
        for k in list(subs.keys()):
            if target in subs[k]:
                coef = subs[k].pop(target)
                for s2, v2 in sub.coeffs.items():
                    nv = hf.add(subs[k].get(s2, 0), hf.mul(coef, v2))
                    if nv == 0:
                        subs[k].pop(s2, None)
                    else:
                        subs[k][s2] = nv
        subs[target] = sub.coeffs
    out_subs = [Substitution(k, v) for k, v in subs.items()]
    return out_subs, cons


def _gauss_cluster_auto(cluster, forbidden, hf):
    """Default strategy: per-cluster dispatch (picklable for the
    process-pool path)."""
    return _gauss_solver_for(cluster, False)(cluster, forbidden, hf)


def _gauss_solver_for(cluster, use_old_heuristics):
    """Strategy dispatch per cluster, mirroring full_simplification
    (simplification_utils.rs:547-571): the least-occurrences strategy
    applies to clusters of 350..1M constraints unless the old
    heuristics are requested; smaller/larger clusters (and the
    --use_old_simplification_heuristics flag) use the
    largest-signal strategy."""
    n = len(cluster)
    if 350 <= n < 1_000_000 and not use_old_heuristics:
        return _gauss_cluster_new
    return _gauss_cluster


def _solve_clusters(clusters, forbidden, hf, solver, parallel):
    """Solve independent signal clusters, optionally on a process pool.

    The reference dispatches each cluster to a threadpool
    (constraint_simplification.rs:198-251, 275-327); clusters are
    connected components of the signal graph, so they are embarrassingly
    parallel.  Results are collected in submission order, keeping the
    simplification (and therefore .r1cs/.sym wire numbering)
    deterministic regardless of worker count."""
    if not parallel or len(clusters) < 4:
        return [solver(cl, forbidden, hf) for cl in clusters]
    import concurrent.futures as cf
    import functools
    import os

    workers = min(os.cpu_count() or 1, len(clusters))
    chunk = max(1, len(clusters) // (workers * 4))
    try:
        with cf.ProcessPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(
                functools.partial(solver, forbidden=forbidden, hf=hf),
                clusters, chunksize=chunk))
    except (OSError, cf.process.BrokenProcessPool):
        # sandboxed environments without fork/spawn: run sequentially
        return [solver(cl, forbidden, hf) for cl in clusters]


def simplify(dag: DAG, hf: HostField, mode: str = "O1", rounds: int = 0,
             parallel: bool = False, use_old_heuristics: bool = False):
    """mode: 'O1' (equalities + constants) or 'O2' (adds linear Gauss).

    use_old_heuristics mirrors --use_old_simplification_heuristics:
    always the largest-signal elimination strategy; the default picks
    least-occurrences for mid-size clusters (full_simplification,
    simplification_utils.rs:547-571)."""
    gauss = _gauss_cluster if use_old_heuristics else _gauss_cluster_auto
    forbidden = set(dag.get_main().forbidden_if_main)
    const_eqs, eqs, linear, nonlinear = [], [], [], []
    max_signal = 1
    custom_signals = []
    for _path, node, offset in dag.walk():
        for s in node.local_signals_sorted():
            if node.is_custom_gate:
                forbidden.add(s + offset)
            max_signal += 1
        for c in node.constraints:
            if c.is_empty():
                continue
            g = DAG._offset_constraint(c, offset)
            if g.is_constant_equality():
                const_eqs.append(g)
            elif g.is_equality(hf):
                eqs.append(g)
            elif g.is_linear():
                linear.append(g)
            else:
                nonlinear.append(g)

    deleted = set()
    lconst = []
    substitutions = {}

    # phase 1: equality clusters
    clusters = _build_clusters(eqs)
    eq_frame = {}
    for subs, cons in _solve_clusters(clusters, forbidden, hf,
                                      _eq_cluster_simplification, parallel):
        lconst.extend(cons)
        for s in subs:
            eq_frame[s.signal] = s.coeffs
            deleted.add(s.signal)
    for c in linear:
        _apply_frames(c, [eq_frame], hf)
    for c in const_eqs:
        _apply_frames(c, [eq_frame], hf)

    # phase 2: constant equalities
    subs, cons = _constant_eq_simplification(
        [c for c in const_eqs if not c.is_empty()], forbidden, hf)
    lconst.extend(cons)
    const_frame = {}
    for s in subs:
        const_frame[s.signal] = s.coeffs
        deleted.add(s.signal)
    for c in linear:
        _apply_frames(c, [const_frame], hf)

    # phase 3: linear Gauss (O2)
    frames = [eq_frame, const_frame]
    lin_frame = {}
    if mode == "O2":
        clusters = _build_clusters([c for c in linear if not c.is_empty()])
        for subs, cons in _solve_clusters(clusters, forbidden, hf,
                                          gauss, parallel):
            lconst.extend(cons)
            for s in subs:
                lin_frame[s.signal] = s.coeffs
                deleted.add(s.signal)
        for c in lconst:
            _apply_frames(c, [lin_frame], hf)
        frames.append(lin_frame)
    else:
        lconst.extend(c for c in linear if not c.is_empty())

    # phase 4: nonlinear set with frames applied
    storage = []
    became_linear = []
    for c in nonlinear:
        _apply_frames(c, frames, hf)
        if c.is_empty():
            continue
        if c.is_linear():
            became_linear.append(c)
        else:
            storage.append(c)

    # phase 5 (O2): iterate linear rounds over nonlinears that became
    # linear (constraint_simplification.rs:600-646 while apply_round)
    rounds_left = max(rounds - 1, 0) if mode == "O2" else 0
    while rounds_left > 0 and became_linear:
        round_frame = {}
        clusters = _build_clusters(
            [c for c in became_linear if not c.is_empty()])
        became_linear = []
        for subs, cons in _solve_clusters(clusters, forbidden, hf,
                                          gauss, parallel):
            lconst.extend(cons)
            for s in subs:
                round_frame[s.signal] = s.coeffs
                deleted.add(s.signal)
        if not round_frame:
            break
        for c in lconst:
            _apply_frames(c, [round_frame], hf)
        new_storage = []
        for c in storage:
            _apply_frames(c, [round_frame], hf)
            if c.is_empty():
                continue
            if c.is_linear():
                became_linear.append(c)
            else:
                new_storage.append(c)
        storage = new_storage
        lin_frame.update(round_frame)
        rounds_left -= 1

    storage.extend(c for c in became_linear if not c.is_empty())
    for c in lconst:
        c.fixed(hf)
        if not c.is_empty():
            storage.append(c)

    # rebuild witness (constraint_simplification.rs:101-125)
    used = set()
    for c in storage:
        used |= c.signals()
    signal_map = {}
    free = []      # FIFO of freed signal numbers (consumed via fhead:
    fhead = 0      # a front-pop here is O(n) and this loop is hot)
    for s in range(max_signal):
        if s in deleted:
            free.append(s)
        elif s not in forbidden and s not in used:
            deleted.add(s)
            free.append(s)
        elif fhead < len(free):
            new = free[fhead]
            fhead += 1
            signal_map[s] = new
            free.append(s)
        else:
            signal_map[s] = s

    for k, v in eq_frame.items():
        substitutions[k] = v
    for k, v in const_frame.items():
        substitutions[k] = v
    if mode == "O2":
        for k, v in lin_frame.items():
            substitutions[k] = v

    return SimplifiedSystem(storage, signal_map, max_signal, forbidden,
                            deleted, substitutions)
