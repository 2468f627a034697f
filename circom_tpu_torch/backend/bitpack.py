"""Word-level packing of bit-blasted circuits (SHA-class).

The reference executes bit-blasted gadgets one field op per bit in its
emitted runtimes (code_producers/src/wasm_elements witness calculator);
on TPU that made SHA256 interpreter-dispatch-bound at ~0.7% of useful
compute (docs/ROOFLINE.md).  This pass recovers the 32-bit word
structure from the tape and packs each per-bit gadget family into ONE
int32 slab op sequence:

* **Atoms**: bit nodes with a known (word, position) identity —
  Num2Bits-style extractions ``band(shr_k(X, k), 1)`` of a split-sum
  root X (interp.py split-sum pass), and {0,1}-range main inputs
  grouped 32-per-word by input index.
* **Descriptors**: every narrow node computable from <= 4 atom bits
  gets an exact truth table over those atoms, built bottom-up by
  evaluating the node's op on all atom assignments.  Rotated wirings
  (``in[(k + r) % 32]``) appear as per-atom rotation offsets; the
  mod-32 congruent wrap variants of one gadget merge into a single
  family synthesized with ROTR words.
* **Families**: nodes sharing (truth table, atom rotations) at
  different bit positions.  A packed family computes all its members
  with one bitwise formula over rotated/shifted packed words
  (Shannon-decomposed from the truth table: XOR chains, AND/OR, mux).
* **Consumption**: members feeding bit-lincomb sums are consumed as
  whole shifted words by the split-sum planner; members that are
  witness values are emitted as ONE packed word row and unpacked
  during the witness gather ((row >> bit) & 1); only members with
  other scalar consumers get an explicit 2-op extraction.

The result: SHA256's ~164k per-bit interpreter steps collapse ~20x to
word-level steps, witness-identical (bit values re-derived exactly).

Reference parity note: the reference's C++ runtime computes the same
witness values through full field arithmetic per bit
(fr.hpp short-value path); packing is a TPU-side execution strategy,
not a semantic change.
"""

MAXA = 4          # max distinct atom words per descriptor
MAX_TT_VAL = 1 << 20   # descriptor values stay exact small ints
PACK_MIN = 2      # min family members worth packing


def _identity_tt():
    return (0, 1)


class Family:
    __slots__ = ("tt", "atoms", "nodes", "word", "wraps")

    def __init__(self, tt, atoms):
        self.tt = tt          # tuple over 2^m assignments (atom order)
        self.atoms = atoms    # tuple of (vec, rot mod 32)
        self.nodes = {}       # bit position -> node id
        self.word = None      # synthesized packed node (filled by plan)
        self.wraps = [set() for _ in atoms]  # observed raw rots per atom


class BitPack:
    """Analysis result; the interp planner drives synthesis off it."""

    def __init__(self):
        self.atom = {}         # node -> (vec, pos)
        self.desc = {}         # node -> (tt, atoms((vec, rot)), pos)
        self.fams = []         # list[Family]
        self.member = {}       # node -> (fam index, bit position)
        self.in_words = {}     # vec ("in", j) -> {pos: input node}

    @property
    def n_packed(self):
        return len(self.member)


def analyze(xt, comp, rngx, split_plan, split_shr, nin_of, out_set,
            consumers, absorbed):
    """Build descriptors and packable families over the expanded tape.

    Pure analysis — emits nothing.  ``split_plan``/``split_shr`` come
    from the interp split-sum pass; ``consumers`` maps node -> list of
    consuming compute nodes; ``absorbed`` is the set of nodes the
    split/lincomb passes already swallowed."""
    bp = BitPack()
    kind, ops, args, cval, iidx = (xt.kind, xt.ops, xt.args, xt.cval,
                                   xt.iidx)

    # ---- atoms from Num2Bits-style extractions -----------------------
    for j, (root, k) in split_shr.items():
        if k >= 32:
            continue
        for c in consumers.get(j, ()):  # band(shr, 1) bit nodes
            if ops[c] != "band":
                continue
            cs = [x for x in args[c] if kind[x] == "const"]
            vs = [x for x in args[c] if x == j]
            if len(cs) == 1 and cval[cs[0]] == 1 and vs:
                bp.atom[c] = (("sum", root), k)
    # k == 16 extractions alias to t_n and reach bits via band(t, 1)?
    # (the split pass aliases shr16 -> t; band consumers of the ALIAS
    # target are found through the same shr node in split_shr)

    # ---- atoms from {0,1}-range main inputs, 32 per word -------------
    for i in range(len(ops)):
        if kind[i] == "input" and iidx[i] in nin_of:
            r = rngx[i]
            if r is not None and r == (0, 1):
                vec = ("in", iidx[i] // 32)
                pos = iidx[i] % 32
                bp.atom[i] = (vec, pos)
                bp.in_words.setdefault(vec, {})[pos] = i

    if len(bp.atom) < 64:      # not a bit-blasted circuit; skip
        return None

    # ---- bottom-up descriptors ---------------------------------------
    desc = bp.desc
    half = xt.p >> 1
    for n, (vec, pos) in bp.atom.items():
        desc[n] = (_identity_tt(), ((vec, 0),), pos)

    def const_sv(x):
        v = cval[x]
        sv = v if v <= half else v - xt.p
        return sv if abs(sv) < MAX_TT_VAL else None

    OPS2 = {"mulp": lambda a, b: a * b,
            "add": lambda a, b: a + b,
            "sub": lambda a, b: a - b,
            "band": lambda a, b: a & b,
            "bor": lambda a, b: a | b,
            "bxor": lambda a, b: a ^ b}

    for n in comp:
        if n in bp.atom:
            continue
        op = ops[n]
        if not xt.narrow[n]:
            continue
        if op not in OPS2 and op != "select":
            continue
        # operand descriptors / small consts
        ods = []
        ok = True
        for x in args[n]:
            if kind[x] == "const":
                sv = const_sv(x)
                if sv is None:
                    ok = False
                    break
                ods.append(("c", sv))
            elif x in desc:
                ods.append(("d", desc[x]))
            else:
                ok = False
                break
        if not ok or not any(t == "d" for (t, _) in ods):
            continue
        # merge atoms relative to the first descriptor operand's pos
        P = next(d[2] for (t, d) in ods if t == "d")
        merged = {}
        for (t, d) in ods:
            if t != "d":
                continue
            _tt, atoms_j, pos_j = d
            for (vec, rot) in atoms_j:
                merged.setdefault((vec, rot + pos_j - P), None)
        if len(merged) > MAXA:
            continue
        atom_list = sorted(merged,
                           key=lambda a: (repr(a[0]), a[1] % 32, a[1]))
        aix = {a: k for k, a in enumerate(atom_list)}
        m = len(atom_list)
        # evaluate the op over all atom assignments
        vals = []
        fail = False
        for mask in range(1 << m):
            opv = []
            for (t, d) in ods:
                if t == "c":
                    opv.append(d)
                    continue
                tt_j, atoms_j, pos_j = d
                sub = 0
                for bit, (vec, rot) in enumerate(atoms_j):
                    a = (vec, rot + pos_j - P)
                    if (mask >> aix[a]) & 1:
                        sub |= 1 << bit
                opv.append(tt_j[sub])
            if op == "select":
                v = opv[1] if opv[0] else opv[2]
            else:
                v = OPS2[op](opv[0], opv[1])
            if abs(v) >= MAX_TT_VAL:
                fail = True
                break
            vals.append(v)
        if fail:
            continue
        tt = tuple(vals)
        # normalize: shift rotations so the first atom's rot is 0.
        # Atoms sort by rot MOD 32 so the wrapped variants of one
        # gadget (in[(k+r) % 32] wirings near the word boundary) land
        # in the same canonical order and merge into one family.
        rho = atom_list[0][1]
        atoms_n = tuple((vec, rot - rho) for (vec, rot) in atom_list)
        desc[n] = (tt, atoms_n, P + rho)

    # ---- families (boolean descriptors only) --------------------------
    fam_ix = {}
    for n, (tt, atoms, pos) in desc.items():
        if kind[n] != "compute":
            continue  # input atoms have no step to replace
        if any(v not in (0, 1) for v in tt):
            continue
        p = pos % 32
        key = (tt, tuple((vec, rot % 32) for (vec, rot) in atoms))
        fi = fam_ix.get(key)
        if fi is None:
            fi = fam_ix[key] = len(bp.fams)
            bp.fams.append(Family(tt, key[1]))
        f = bp.fams[fi]
        if p in f.nodes:
            # same (tt, atoms, pos) = same VALUE: tape CSE misses
            # commuted operands (mulp(b,c) vs mulp(c,b)); alias this
            # node to the existing member's packed bit
            if all(0 <= pos + rot < 32 for (_v, rot) in atoms):
                bp.member[n] = (fi, p)
            continue
        # all real atom indices must be in [0, 32) — impossible desc
        # merges (both wrap variants of one atom) fail here and the
        # node stays scalar
        if any(not 0 <= pos + rot < 32 for (_v, rot) in atoms):
            continue
        f.nodes[p] = n
        for k, (_vec, rot) in enumerate(atoms):
            # effective member rotation relative to bit position p:
            # rot + 32*(pos // 32) is in (-32, 32); >= 0 means the
            # member reads an unwrapped (zero-fill shift) index
            f.wraps[k].add(rot + 32 * (pos // 32))
        bp.member[n] = (fi, p)

    # drop families too small to pay for synthesis
    keep = []
    remap = {}
    for fi, f in enumerate(bp.fams):
        is_ident = f.tt == _identity_tt() and len(f.atoms) == 1
        if len(f.nodes) >= PACK_MIN or (is_ident and f.nodes):
            remap[fi] = len(keep)
            keep.append(f)
    bp.fams = keep
    bp.member = {n: (remap[fi], p) for n, (fi, p) in bp.member.items()
                 if fi in remap}

    # NOTE: no up-front scalar-materialization analysis — consumers
    # that truly need a scalar bit extract it lazily at their own plan
    # position ((W >> p) & 1), and the planner's DCE removes whole
    # extraction chains whose consumers all turned out packed.  An
    # eager consumer analysis marked ~16k SHA members scalar for
    # intermediates that pack away entirely.
    return bp


# ---------------------------------------------------------------------
# truth-table -> bitwise formula synthesis
# ---------------------------------------------------------------------

def synth_tt(tt, words, emit2, const_word, memo=None):
    """Emit a bitwise formula computing `tt` over packed `words`.

    tt: tuple of 0/1 over 2^m assignments (bit i of the index = atom i).
    words[i]: operand handle for atom i's aligned word.
    emit2(op, a, b) -> handle emits one narrow op ("nband"/"nbor"/
    "nbxor"); const_word(v) -> handle for an int32 constant.
    Bits outside the family's positions may be garbage (consumers
    mask); only per-position correctness is guaranteed.
    """
    m = len(words)
    if memo is None:
        memo = {}

    def go(tt):
        hit = memo.get(tt)
        if hit is not None:
            return hit
        n = len(tt)
        if all(v == tt[0] for v in tt):
            r = const_word(-1 if tt[0] else 0)
            memo[tt] = r
            return r
        k = n.bit_length() - 2     # highest atom index
        Wk = words[k]
        f0 = tt[:n // 2]
        f1 = tt[n // 2:]
        if f0 == f1:
            r = go_pad(f0)
        elif all(a ^ b == 1 for a, b in zip(f0, f1)):
            # f = Wk XOR f0
            r = emit2("nbxor", Wk, go_pad(f0))
        elif all(v == 0 for v in f0):
            r = emit2("nband", Wk, go_pad(f1))
        elif all(v == 0 for v in f1):
            r = emit2("nband", _not(Wk), go_pad(f0))
        elif all(v == 1 for v in f0):
            r = emit2("nbor", _not(Wk), go_pad(f1))
        elif all(v == 1 for v in f1):
            r = emit2("nbor", Wk, go_pad(f0))
        else:
            r = emit2("nbor",
                      emit2("nband", Wk, go_pad(f1)),
                      emit2("nband", _not(Wk), go_pad(f0)))
        memo[tt] = r
        return r

    def go_pad(sub):
        # evaluate a sub-table over the remaining atoms
        if len(sub) == 1:
            return const_word(-1 if sub[0] else 0)
        return go(sub)

    def _not(w):
        return emit2("nbxor", w, const_word(-1))

    return go(tuple(tt))
