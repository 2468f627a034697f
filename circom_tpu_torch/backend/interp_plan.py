"""Interpreter plan: the numpy-only planner of the in-kernel witness
interpreter.

It turns a DomainTape into static instruction tables: same-opcode runs
(`r_op`, `r_s0`, `rstarts`) over steps (`table`: opcode, operands,
destination register, emission row, immediate/bank row), a constant
bank, per-chunk emission rows and the Montgomery flags of the trailing
REDC (`mont_tab`), and the witness source map (`wit_src`).  The CUDA
interpreter kernel (ops/cuda/interp.cu) and the plain executor
(backend/interp_ref.py) both execute these tables.

The planner is a copy of the JAX package's interpreter planner, so both
packages run identical plans; `plan_arrays()` exports the tables.
"""

import os

import numpy as np

from ..field.primes import FieldSpec
from ..ops.limbs import int_to_limbs
from .plan import ExpandedTape, UnsupportedTapeOp, expanded_ranges

# ops the interpreter kernel supports (dynamic pow/shl/shr/mod were
# already lowered to these by backend/dynops.py; idiv executes as an
# in-kernel long-division fori_loop)
_VV_OPS = {
    "mul", "add", "sub", "select",
    "eq", "neq", "lt", "le", "gt", "ge",
    "land", "lor", "lnot",
    "band", "bor", "bxor", "bnot",
    "idiv",
}
# ops with a constant operand that get a const-bank variant
_C_VARIANTS = {"mul": "mul_c", "add": "add_c", "sub": "sub_c"}

# comparison/boolean ops: always narrow results; _nn reads the narrow
# register file, _ww the wide one (mixed operands widen first)
_CMP = {"eq", "neq", "lt", "le", "gt", "ge", "land", "lor"}

# opcodes whose result lives in the narrow int32 register file
_NARROW_RESULT = (
    {"nmul", "nadd", "nsub", "nsel", "nsel_w", "nband", "nbor", "nbxor",
     "nshl", "nshr", "nshru", "nband_w", "lnot_n", "lnot_w", "nidiv",
     "ncopy", "nxbit", "nmshl", "nmshru", "nrotr"}
    | {f"{o}_nn" for o in _CMP} | {f"{o}_ww" for o in _CMP}
)

# operand register files per opcode position ('n' narrow / 'w' wide);
# default is all-wide
_OPERAND_FILES = {
    "nmul": ("n", "n", "w"), "nadd": ("n", "n", "w"),
    "nsub": ("n", "n", "w"), "nband": ("n", "n", "w"),
    "nbor": ("n", "n", "w"), "nbxor": ("n", "n", "w"),
    "nsel": ("n", "n", "n"), "nsel_w": ("w", "n", "n"),
    "nidiv": ("n", "n", "w"), "ncopy": ("n", "n", "w"),
    "nshl": ("n", "w", "w"), "nshr": ("n", "w", "w"),
    "nshru": ("n", "w", "w"),
    # fused planner ops (r5): bit extract, mask+shift, rotate —
    # one dispatch instead of two/three on SHA-class hot paths
    "nxbit": ("n", "w", "w"), "nrotr": ("n", "w", "w"),
    "nmshl": ("n", "n", "w"), "nmshru": ("n", "n", "w"),
    "nband_w": ("w", "w", "w"), "widen": ("n", "w", "w"),
    "lnot_n": ("n", "w", "w"), "lnot_w": ("w", "w", "w"),
}
for _o in _CMP:
    _OPERAND_FILES[f"{_o}_nn"] = ("n", "n", "w")
    _OPERAND_FILES[f"{_o}_ww"] = ("w", "w", "w")


def mixed_split(wit_src, nin_of, win_of, K, KN, n_chunks):
    """Classify wit_src into narrow and wide witness rows, in the port's
    bank layout: every chunk in order (row chunk*(K+1) + em), with no
    per-call padding, so a plan without steps has one dump row a bank.

    Returns ((nw_src, nw_shift, wd_src), (nw_idx, wd_idx), consts).  A
    narrow row reads [narrow bank; narrow inputs] and unpacks bit
    nw_shift (-1: raw); a wide row reads [wide bank; wide inputs (at least
    one slot); consts].  nw_idx and wd_idx are the witness indices."""
    n_flat_w, n_flat_n = n_chunks * (K + 1), n_chunks * (KN + 1)
    nw_src, wd_src, nw_idx, wd_idx = [], [], [], []
    nw_shift = []   # per narrow row: -1 raw, else unpack bit index
    consts = []
    const_pos = {}
    for w_i, src in enumerate(wit_src):
        if src[0] == "emitb":
            nw_src.append(src[1] * (KN + 1) + src[2])
            nw_shift.append(src[3])
            nw_idx.append(w_i)
        elif src[0] == "emitn":
            nw_src.append(src[1] * (KN + 1) + src[2])
            nw_shift.append(-1)
            nw_idx.append(w_i)
        elif src[0] == "emit":
            wd_src.append(src[1] * (K + 1) + src[2])
            wd_idx.append(w_i)
        elif src[0] == "input":
            if src[1] in nin_of:
                nw_src.append(n_flat_n + nin_of[src[1]])
                nw_shift.append(-1)
                nw_idx.append(w_i)
            else:
                wd_src.append(n_flat_w + win_of[src[1]])
                wd_idx.append(w_i)
        else:
            v = src[1]
            if v not in const_pos:
                const_pos[v] = len(consts)
                consts.append(v)
            wd_src.append(n_flat_w + max(len(win_of), 1) + const_pos[v])
            wd_idx.append(w_i)
    return (nw_src, nw_shift, wd_src), (nw_idx, wd_idx), consts


class InterpreterPlan:
    """Instruction tables of the interpreter for one field."""

    def __init__(self, dtape, spec: FieldSpec, *, chunk_emits=32,
                 chunk_emits_n=256, max_regs=2048, input_ranges=None,
                 max_call_steps=24_000):
        self.spec = spec
        self.L = spec.n_limbs
        self.K = chunk_emits
        self.KN = chunk_emits_n
        self.input_ranges = input_ranges or {}
        self.max_call_steps = max_call_steps
        self.n_inputs = dtape.n_inputs
        self.xt = ExpandedTape(dtape, spec)
        self._plan(max_regs)
        self.n_witness = len(self.xt.out_ids)
        self.hbm_nin = self.n_nin > 64
        # The JAX planner refuses tapes whose register files and
        # emission blocks cannot fit 13 MB at 128 lanes (its batch
        # block).  The same refusal here keeps the set of tapes that
        # both packages accept identical.
        tiles = (self.n_regs * self.L + self.n_nregs
                 + 2 * (self.K + 2) * self.L
                 + 2 * (self.KN + 2)
                 + 2 * max(self.n_win, 1) * self.L
                 + 2 * (1 if self.hbm_nin else max(self.n_nin, 1)))
        if tiles * 8 * 128 * 4 > 13 << 20:
            raise UnsupportedTapeOp(
                f"register files exceed VMEM ({tiles} tiles)")

    # ------------------------------------------------------------------
    def _plan(self, max_regs):
        xt = self.xt
        L = self.L
        one_v = 1
        r2_v = (xt.R * xt.R) % xt.p
        half = xt.p >> 1

        comp = [i for i in range(len(xt.ops))
                if xt.kind[i] == "compute" and xt.live[i]]
        comp = self._reorder(comp, r2_v)
        out_set = set(xt.out_ids)

        # --- operand normalization ------------------------------------
        bank_vals = []          # const-bank rows (values)
        bank_dedup = {}
        mat_ix = {}             # const value -> wide materialized slot
        nmat_ix = {}            # signed int32 const -> narrow slot
        steps = []              # (op, a, b, c, node, aux)

        def bank(v):
            hit = bank_dedup.get(v)
            if hit is None:
                hit = bank_dedup[v] = len(bank_vals)
                bank_vals.append(v)
            return hit

        def bank_range(vals):
            """Consecutive bank rows (dot coefficient blocks)."""
            base = len(bank_vals)
            bank_vals.extend(vals)
            return base

        def materialize(v):
            hit = mat_ix.get(v)
            if hit is None:
                hit = mat_ix[v] = len(mat_ix)
            return hit

        def signed_of(v):
            return v if v <= half else v - xt.p

        def nfits(v):
            return abs(signed_of(v)) <= (1 << 31) - 1

        def nmat_signed(sv):
            """Narrow const slot for a raw signed int32 bit pattern."""
            hit = nmat_ix.get(sv)
            if hit is None:
                hit = nmat_ix[sv] = len(nmat_ix)
            return hit

        def nmaterialize(v):
            return nmat_signed(signed_of(v))

        alias = {}

        def res(a):
            while a in alias:
                a = alias[a]
            return a

        # inputs with int32-provable range hints (signal tags) live in
        # the narrow register file; the rest in the wide one
        NM31 = (1 << 31) - 1
        self.nin_of = {}
        self.win_of = {}
        for idx in range(self.n_inputs):
            h = self.input_ranges.get(idx)
            if h is not None and 0 <= h[0] and h[1] <= NM31:
                self.nin_of[idx] = len(self.nin_of)
            else:
                self.win_of[idx] = len(self.win_of)

        node_narrow = {}
        for i0 in range(len(xt.ops)):
            if xt.kind[i0] == "compute":
                node_narrow[i0] = bool(xt.narrow[i0])
            elif xt.kind[i0] == "input":
                node_narrow[i0] = xt.iidx[i0] in self.nin_of

        def is_nrw(x):
            return node_narrow.get(x, False)

        def synth(narrow=False):
            nid = len(xt.ops)
            xt.ops.append("_tmp")
            xt.args.append(())
            xt.imms.append(None)
            xt.kind.append("compute")
            xt.cval.append(None)
            xt.iidx.append(None)
            xt.narrow.append(narrow)
            xt.live.append(True)
            node_narrow[nid] = narrow
            return nid

        widened = {}

        def wide_of(x):
            """Wide (L-limb) view of a narrow node: emits one `widen`
            step per node, cached."""
            w = widened.get(x)
            if w is None:
                w = synth(False)
                widened[x] = w
                steps.append(("widen", x, None, None, w, None))
            return w

        def wform(x):
            """Operand in wide form (const -> wide materialized reg)."""
            if xt.kind[x] == "const":
                return ("mat", materialize(xt.cval[x]))
            if is_nrw(x):
                return wide_of(x)
            return x

        def nform(x):
            """Operand in narrow form (const -> narrow slot)."""
            if xt.kind[x] == "const":
                return ("nmat", nmaterialize(xt.cval[x]))
            return x

        # --- lincomb fusion pre-pass ------------------------------------
        # MDS-style rows arrive as add(add(add(K, mul_c), mul_c), mul_c):
        # fuse single-use mul_c terms under single-use adds into dot ops
        # that accumulate every convolution into ONE column set and
        # Montgomery-reduce once (lazy reduction; ~30% off MDS cost).
        uses = {}
        for i in comp:
            for x in xt.args[i]:
                if xt.kind[x] == "compute":
                    uses[x] = uses.get(x, 0) + 1
        for o in xt.out_ids:
            uses[o] = uses.get(o, 0) + 1

        rngx = expanded_ranges(xt, self.input_ranges)
        roots, absorbed = {}, set()

        # --- split-sum pre-pass -----------------------------------------
        # Bit-decomposition sums (AddModW `lc` in SHA, Num2Bits-style
        # hints — the reference executes these as full field arithmetic
        # in its runtimes, witness_calculator.js:131-211): a wide
        # add-tree X = sum(narrow terms) whose ONLY consumers are
        # (X >> k) & m extractions never needs limb form.  Keep it as
        # two int32 component sums with X = S_lo + 2^16*S_hi exactly:
        #   bits 0..15 of X  == bits 0..15 of S_lo   (2^16*S_hi ≡ 0)
        #   X >> 16          == S_hi + (S_lo >> 16)  =: T
        # so every extraction is a narrow shift+mask.  Weight products
        # (bit*2^k, CSE'd across sums in the tape) are REMATERIALIZED
        # per sum: shared product nodes otherwise stay live for ~16 SHA
        # rounds (measured 2,048 >20k-step live spans = a 14MB narrow
        # register file).
        split_plan = {}    # root -> (lo_terms, hi_terms, K_lo, K_hi)
        split_shr = {}     # shr node -> (root, k)
        splitrep = {}      # root -> (lo_node, t_node), filled at emit
        consumers = {}
        for i in comp:
            for x in xt.args[i]:
                consumers.setdefault(x, []).append(i)

        def _split_leaf(x):
            """(lo_terms, hi_terms, lo_ub, hi_ub) for leaf x, items are
            ('node', id), ('prod', arg, const), ('lo16'/'hi16', id);
            None if unsplittable.  Constant-weight products split by
            their constant (bit*2^k with k>=16 contributes only to the
            hi sum, as bit*2^(k-16))."""
            if xt.kind[x] == "compute" and xt.ops[x] == "mulp":
                a0, a1 = xt.args[x]
                if xt.kind[a1] == "const":
                    v, cn = a0, a1
                elif xt.kind[a0] == "const":
                    v, cn = a1, a0
                else:
                    v = cn = None
                if v is not None:
                    rv = rngx[v]
                    c = xt.cval[cn]
                    if rv is None or rv[0] < 0 or c >= (1 << 47) \
                            or not is_nrw(v):
                        return None
                    c_lo, c_hi = c & 0xffff, c >> 16
                    if c_lo * rv[1] > NM31 or c_hi * rv[1] > NM31:
                        return None
                    lo = [("prod", v, c_lo)] if c_lo else []
                    hi = [("prod", v, c_hi)] if c_hi else []
                    return (lo, hi, c_lo * rv[1], c_hi * rv[1])
            r = rngx[x]
            if is_nrw(x) and r is not None and r[0] >= 0:
                return ([("node", x)], [], r[1], 0)
            return None

        split_prod_uses = {}
        for i in reversed(comp):
            if xt.ops[i] != "add" or is_nrw(i) or i in absorbed \
                    or i in out_set:
                continue
            cons = consumers.get(i, [])
            if not cons:
                continue
            ok, shrs = True, []
            for j in cons:
                if xt.kind[j] != "compute" or xt.ops[j] != "shr_k" \
                        or xt.args[j][0] != i:
                    ok = False
                    break
                k = xt.imms[j]
                if k < 16:
                    if j in out_set:
                        ok = False
                        break
                    for j2 in consumers.get(j, []):
                        if xt.ops[j2] != "band":
                            ok = False
                            break
                        ms = [x for x in xt.args[j2]
                              if xt.kind[x] == "const"]
                        if len(ms) != 1 \
                                or xt.cval[ms[0]] >= (1 << (16 - k)):
                            ok = False
                            break
                    if not ok:
                        break
                shrs.append((j, k))
            if not ok:
                continue
            leaves, K_acc, local = [], 0, []
            stack = list(xt.args[i])
            while stack:
                x = stack.pop()
                if xt.kind[x] == "const":
                    K_acc = (K_acc + xt.cval[x]) % xt.p
                    continue
                if (xt.kind[x] == "compute" and xt.ops[x] == "add"
                        and not is_nrw(x) and uses.get(x, 0) == 1
                        and x not in out_set and x not in absorbed):
                    local.append(x)
                    stack.extend(xt.args[x])
                    continue
                leaves.append(x)
            if K_acc >= (1 << 46):
                continue
            lo_t, hi_t = [], []
            lo_ub = K_acc & 0xffff
            hi_ub = K_acc >> 16
            for x in leaves:
                parts = _split_leaf(x)
                if parts is None:
                    ok = False
                    break
                pl_, ph_, lu, hu = parts
                if lo_ub + lu > NM31 and pl_ == [("node", x)]:
                    # lo sum would overflow int32: split the whole-value
                    # leaf into 16-bit halves (2 extra narrow ops)
                    pl_ = [("lo16", x)]
                    ph_ = ph_ + [("hi16", x)]
                    lu, hu = 0xffff, rngx[x][1] >> 16
                lo_t.extend(pl_)
                hi_t.extend(ph_)
                lo_ub += lu
                hi_ub += hu
            if not ok or not lo_t or lo_ub > NM31 \
                    or hi_ub + (lo_ub >> 16) > NM31:
                continue
            split_plan[i] = (lo_t, hi_t, K_acc & 0xffff, K_acc >> 16)
            absorbed.update(local)
            for (j, k) in shrs:
                split_shr[j] = (i, k)
                node_narrow[j] = True
                if k >= 16:
                    # exact value of X >> k (k<16 extractions are only
                    # valid under their band masks; leave range unknown)
                    rngx[j] = (0, (lo_ub + (hi_ub << 16)) >> k)
            for x in leaves:
                if xt.kind[x] == "compute" and xt.ops[x] == "mulp":
                    split_prod_uses[x] = split_prod_uses.get(x, 0) + 1
        # product nodes used only as split-sum leaves never materialize
        for x, n_su in split_prod_uses.items():
            if n_su == uses.get(x, 0) and x not in out_set:
                absorbed.add(x)
        # snapshot: bitpack's consumer analysis must distinguish
        # split-sum absorption (packed words are consumed whole there)
        # from the later lincomb/nroot absorption (scalar operands)
        split_absorbed = set(absorbed)

        def mulc_leaf(x):
            if xt.ops[x] != "mul" or uses.get(x, 0) != 1 or x in out_set:
                return None
            a0, a1 = xt.args[x]
            if xt.kind[a0] == "const" and xt.kind[a1] != "const" \
                    and not is_nrw(a1):
                return (a1, xt.cval[a0])
            if xt.kind[a1] == "const" and xt.kind[a0] != "const" \
                    and not is_nrw(a0):
                return (a0, xt.cval[a1])
            return None

        for i in reversed(comp):
            if xt.ops[i] != "add" or i in absorbed or is_nrw(i) \
                    or i in split_plan:
                continue
            terms, bares, K_acc, local = [], [], 0, []
            stack = list(xt.args[i])
            while stack:
                x = stack.pop()
                if xt.kind[x] == "const":
                    K_acc = (K_acc + xt.cval[x]) % xt.p
                    continue
                if xt.kind[x] == "input":
                    bares.append(x)
                    continue
                t = mulc_leaf(x)
                if t is not None:
                    terms.append(t)
                    local.append(x)
                    continue
                if (xt.ops[x] == "add" and uses.get(x, 0) == 1
                        and not is_nrw(x)
                        and x not in out_set and x not in absorbed):
                    local.append(x)
                    stack.extend(xt.args[x])
                    continue
                bares.append(x)
            if len(terms) >= 2:
                roots[i] = (terms, bares, K_acc)
                absorbed.update(local)

        # --- narrow-sum reassociation pre-pass ---------------------------
        # Bit-lincomb adders (sum of bit*2^k, SHA AddModW) arrive as long
        # WIDE add chains because the source-order partial sums overflow
        # int32 after ~31 terms.  Field addition is associative:
        # regroup narrow leaves into int32-safe partial sums (nadd
        # chains), widen each group once, and wide-add the few groups.
        NM = (1 << 31) - 1
        nroots = {}
        for i in reversed(comp):
            if xt.ops[i] != "add" or is_nrw(i) or i in absorbed \
                    or i in roots or i in split_plan:
                continue
            leaves_n, leaves_w, K2, local = [], [], 0, []
            stack = list(xt.args[i])
            while stack:
                x = stack.pop()
                if xt.kind[x] == "const":
                    K2 = (K2 + xt.cval[x]) % xt.p
                    continue
                if (xt.kind[x] == "compute" and xt.ops[x] == "add"
                        and not is_nrw(x) and uses.get(x, 0) == 1
                        and x not in out_set and x not in absorbed
                        and x not in roots):
                    local.append(x)
                    stack.extend(xt.args[x])
                    continue
                if is_nrw(x) and rngx[x] is not None:
                    leaves_n.append(x)
                else:
                    leaves_w.append(x)
            if len(leaves_n) >= 4:
                nroots[i] = (leaves_n, leaves_w, K2)
                absorbed.update(local)

        if os.environ.get("CTPU_DEBUG"):
            print(f"# plan: split={len(split_plan)} roots={len(roots)} "
                  f"nroots={len(nroots)} absorbed={len(absorbed)}")
        import collections as _c
        _dbg_rest = _c.Counter()

        # --- word-level bit packing (SHA-class; backend/bitpack.py) ---
        bitpack = None
        if split_shr or len(self.nin_of) >= 64:
            from . import bitpack as _bitpack
            bitpack = _bitpack.analyze(
                xt, comp, rngx, split_plan, split_shr, self.nin_of,
                out_set, consumers, split_absorbed)
        fam_member = bitpack.member if bitpack else {}

        # --- narrow word-sum pass -------------------------------------
        # CSE-shared NARROW add-trees of bit*2^k products (binsum
        # partial sums in SHA) bypass both the split-sum pass and the
        # nroots reassociation (wide roots only), leaving their
        # products to execute scalar (~5.3k nmul + ~5.4k nadd on
        # SHA256 post-DCE).  Same cure as the split path: group
        # family-member / input-atom products into whole masked+
        # shifted packed words via _grouped; the tree is proven int32
        # so the group sums stay narrow with no lo/hi split.
        nword_plan = {}
        if bitpack is not None:
            half_p = xt.p >> 1
            nword_prod_uses = {}
            for i in reversed(comp):
                if xt.ops[i] != "add" or not is_nrw(i) \
                        or i in absorbed or i in fam_member \
                        or rngx[i] is None:
                    continue
                leaves, K_acc, local = [], 0, []
                stack = list(xt.args[i])
                while stack:
                    x = stack.pop()
                    if xt.kind[x] == "const":
                        K_acc = (K_acc + xt.cval[x]) % xt.p
                        continue
                    if (xt.kind[x] == "compute" and xt.ops[x] == "add"
                            and is_nrw(x) and uses.get(x, 0) == 1
                            and x not in out_set and x not in absorbed
                            and x not in fam_member
                            and x not in nword_plan):
                        local.append(x)
                        stack.extend(xt.args[x])
                        continue
                    leaves.append(x)
                K_sv = K_acc if K_acc <= half_p else K_acc - xt.p
                if abs(K_sv) > NM31:
                    continue
                # classify leaves; track positive/negative partial-sum
                # bounds (any accumulation order must stay int32)
                items, prods = [], []
                groups = {}
                pos_b = max(K_sv, 0)
                neg_b = min(K_sv, 0)
                ok = True
                for x in leaves:
                    r = rngx[x]
                    if r is None:
                        ok = False
                        break
                    pos_b += max(r[1], 0)
                    neg_b += min(r[0], 0)
                    v = c = None
                    if xt.kind[x] == "compute" and xt.ops[x] == "mulp":
                        a0, a1 = xt.args[x]
                        if xt.kind[a1] == "const":
                            v, cn = a0, a1
                        elif xt.kind[a0] == "const":
                            v, cn = a1, a0
                        else:
                            v = None
                        if v is not None:
                            c = xt.cval[cn]
                            if not c or (c & (c - 1)) \
                                    or not (v in fam_member
                                            or v in bitpack.atom):
                                v = None
                    if v is not None:
                        m = fam_member.get(v)
                        sk = (("f", m[0]) if m is not None
                              else ("v", bitpack.atom[v][0]))
                        p_ = (m[1] if m is not None
                              else bitpack.atom[v][1])
                        groups.setdefault(
                            (sk, c.bit_length() - 1 - p_),
                            []).append((x, v, c))
                    else:
                        items.append(("node", x))
                if not ok or pos_b > NM31 or neg_b < -NM31:
                    continue
                n_grouped = sum(len(g) for g in groups.values()
                                if len(g) >= 3)
                if n_grouped < 3:
                    continue
                for g in groups.values():
                    for (x, v, c) in g:
                        items.append(("prod", v, c))
                        prods.append(x)
                nword_plan[i] = (items, K_acc)
                absorbed.update(local)
                for x in prods:
                    nword_prod_uses[x] = nword_prod_uses.get(x, 0) + 1
            # product nodes whose every use is covered by split-sum
            # leaves and/or nword groups never materialize scalar
            for x, n_su in nword_prod_uses.items():
                if n_su + split_prod_uses.get(x, 0) \
                        == uses.get(x, 0) and x not in out_set:
                    absorbed.add(x)
            if os.environ.get("CTPU_DEBUG") and nword_plan:
                print(f"# nword: {len(nword_plan)} narrow word-sums, "
                      f"{len(nword_prod_uses)} grouped products")
        self.n_nword = len(nword_plan)
        vec_words, fam_words = {}, {}

        def emit_n1(op, a, imm=None):
            nid = synth(True)
            steps.append((op, a, None, None, nid, imm))
            return nid

        def emit_n2(op, a, b):
            nid = synth(True)
            steps.append((op, a, b, None, nid, None))
            return nid

        def emit_n2i(op, a, b, imm):
            nid = synth(True)
            steps.append((op, a, b, None, nid, imm))
            return nid

        def cword(sv):
            return ("nmat", nmat_signed(sv))

        def as_node(h):
            """Materialize a const handle as a narrow register node
            (needed when a packed word is itself emitted)."""
            if isinstance(h, tuple):
                return emit_n2("nbor", h, h)
            return h

        def get_vec_word(vec):
            """Packed 32-bit word for an atom vector."""
            w = vec_words.get(vec)
            if w is not None:
                return w
            if vec[0] == "sum":
                lo, t_n = splitrep[vec[1]]
                a = emit_n2("nband", lo, cword(0xffff))
                w = emit_n2("nbor", a,
                            emit_n2i("nmshl", t_n, cword(0xffff), 16))
            else:  # ("in", word index): assemble from input bit nodes
                bits = bitpack.in_words[vec]
                parts = [emit_n1("nshl", nform(n), k) if k else nform(n)
                         for k, n in sorted(bits.items())]
                while len(parts) > 1:
                    nxt = [emit_n2("nbor", parts[j], parts[j + 1])
                           for j in range(0, len(parts) - 1, 2)]
                    if len(parts) % 2:
                        nxt.append(parts[-1])
                    parts = nxt
                w = parts[0]
                if not isinstance(w, tuple) and xt.kind[w] != "compute":
                    # a single-bit word at shift 0 is the raw input
                    # node; packed words must be compute registers so
                    # an emitb witness row has an emission step to
                    # gather from (advisor r4 finding)
                    w = emit_n1("ncopy", w)
            vec_words[vec] = w
            return w

        atom_words = {}

        def atom_word(vec, rot, raws):
            """Aligned word: bit p holds vec[(p + rot) mod 32], by
            logical shift when no member wraps, ROTR when some do.
            Memoized on (vec, rot, shift directions): sigma-family
            rotations repeat across gadget families (~1.4k duplicate
            syntheses on SHA256, ~2 ops each)."""
            key = (vec, rot, any(r >= 0 for r in raws),
                   any(r < 0 for r in raws))
            w = atom_words.get(key)
            if w is not None:
                return w
            W = get_vec_word(vec)
            if rot == 0:
                atom_words[key] = W
                return W
            if key[2] and key[3]:
                w = emit_n1("nrotr", W, rot)  # fused rotate (1 step)
            elif key[2]:
                w = emit_n1("nshru", W, rot)
            else:
                w = emit_n1("nshl", W, 32 - rot)
            atom_words[key] = w
            return w

        def get_fam_word(fi):
            w = fam_words.get(fi)
            if w is not None:
                return w
            f = bitpack.fams[fi]
            words = [atom_word(vec, rot, f.wraps[k])
                     for k, (vec, rot) in enumerate(f.atoms)]
            if f.tt == (0, 1):
                w = words[0]
            else:
                w = _bitpack.synth_tt(f.tt, words, emit_n2, cword)
            w = fam_words[fi] = as_node(w)
            return w

        def _nterm(it):
            """Narrow register holding one split-sum term."""
            if it[0] == "node":
                return nform(sres(it[1]))
            if it[0] == "lo16":
                nid = synth(True)
                steps.append(("nband", nform(res(it[1])),
                              ("nmat", nmaterialize(0xffff)), None,
                              nid, None))
                return nid
            if it[0] == "hi16":
                nid = synth(True)
                steps.append(("nshr", nform(res(it[1])), None, None,
                              nid, 16))
                return nid
            _tag, v, c = it
            nid = synth(True)
            steps.append(("nmul", nform(sres(v)),
                          ("nmat", nmaterialize(c)), None, nid, None))
            return nid

        def _nsum(terms, k_const, extra=()):
            """nadd reduction over split-sum terms (+ constant);
            returns the operand (register id or nmat tuple).  Eight
            parallel accumulator chains + a final tree: wide enough
            that the run scheduler batches the adds, narrow enough
            that only ~8 partials are live (a full balanced tree keeps
            n/2 partials live and blows the register file)."""
            parts = list(extra) + [_nterm(it) for it in terms]
            if k_const:
                parts.append(("nmat", nmaterialize(k_const)))
            A = 8
            if len(parts) > 2 * A:
                accs = list(parts[:A])
                for j, x in enumerate(parts[A:]):
                    nid = synth(True)
                    steps.append(("nadd", accs[j % A], x, None,
                                  nid, None))
                    accs[j % A] = nid
                parts = accs
            while len(parts) > 1:
                nxt = []
                for j in range(0, len(parts) - 1, 2):
                    nid = synth(True)
                    steps.append(("nadd", parts[j], parts[j + 1], None,
                                  nid, None))
                    nxt.append(nid)
                if len(parts) % 2:
                    nxt.append(parts[-1])
                parts = nxt
            return parts[0]

        scalar_bits = {}

        def scalar_bit(n):
            """Materialize one packed member as a scalar 0/1 register
            ((W >> p) & 1), memoized."""
            h = scalar_bits.get(n)
            if h is None:
                fi, p = fam_member[n]
                W = get_fam_word(fi)
                h = emit_n1("nxbit", W, p)  # fused (W >>u p) & 1
                scalar_bits[n] = h
            return h

        def sres(x):
            """res() + lazy scalar extraction of packed members: any
            plan site that reads a packed bit as a scalar operand gets
            the 2-op extraction at its own position; DCE later removes
            chains whose consumers all packed away."""
            x = res(x)
            if x in fam_member:
                return scalar_bit(x)
            return x

        def _grouped(items):
            """Partition split-sum terms: bit-products of packed family
            members group into whole shifted/masked packed words (one
            32-term word sum becomes ~2 ops); the rest stay scalar."""
            groups, rest = {}, []
            for it in items:
                v = c = None
                if it[0] == "prod" and it[2] and (it[2] & (it[2] - 1)) \
                        == 0:
                    v, c = res(it[1]), it[2]
                elif it[0] == "node":
                    v, c = res(it[1]), 1
                src = None
                if v is not None:
                    m = fam_member.get(v)
                    if m is not None:
                        src = (("f", m[0]), m[1])
                    elif xt.kind[v] == "input":
                        at = bitpack.atom.get(v)
                        if at is not None:
                            src = (("v", at[0]), at[1])
                if src is None:
                    if os.environ.get("CTPU_DEBUG"):
                        _dbg_rest[(it[0],
                                   xt.ops[v] if v is not None
                                   and xt.kind[v] == "compute"
                                   else "?")] += 1
                    rest.append(it)
                    continue
                (sk, p) = src[0], src[1]
                d = c.bit_length() - 1 - p     # weight k = p + d
                g = groups.setdefault((sk, d), [0, [], []])
                if g[0] & (1 << p):
                    # DUPLICATED term (same bit, same weight — e.g. a
                    # source-level `x + x`): a mask bit can only count
                    # it once, so extra occurrences stay scalar
                    rest.append(it)
                    continue
                g[0] |= 1 << p
                g[1].append(p)
                g[2].append(it)
            extra = []
            for (sk, d), (mask, ps, its) in groups.items():
                if os.environ.get("CTPU_DEBUG"):
                    _dbg_rest[("grp", len(ps) if len(ps) < 3
                               else ">=3")] += 1
                if len(ps) < 3:
                    # not worth word ops: scalar term (with extraction
                    # for packed members; input bits read directly)
                    for p, it in zip(ps, its):
                        if sk[0] == "f":
                            n = bitpack.fams[sk[1]].nodes[p]
                            h = scalar_bit(n)
                            w = 1 << (p + d)
                            rest.append(("node", h) if w == 1
                                        else ("prod", h, w))
                        else:
                            rest.append(it)
                    continue
                if sk[0] == "f":
                    V = get_fam_word(sk[1])
                    full = mask == 0xffffffff \
                        and len(bitpack.fams[sk[1]].nodes) == 32
                else:
                    V = get_vec_word(sk[1])
                    present = 0
                    for k2 in bitpack.in_words[sk[1]]:
                        present |= 1 << k2
                    full = mask == present
                if not full:
                    sm = mask if mask < (1 << 31) else mask - (1 << 32)
                    if d > 0:
                        V = emit_n2i("nmshl", V, cword(sm), d)
                    elif d < 0:
                        V = emit_n2i("nmshru", V, cword(sm), -d)
                    else:
                        V = emit_n2("nband", V, cword(sm))
                elif d > 0:
                    V = emit_n1("nshl", V, d)
                elif d < 0:
                    V = emit_n1("nshru", V, -d)
                extra.append(V)
            return extra, rest

        for i in comp:
            if i in absorbed:
                continue
            if bitpack is not None and i in fam_member:
                if i in out_set:
                    # synthesize the packed word AT the first emitted
                    # member's position — deferring to the tape tail
                    # would keep every atom register (sum lo/t pairs)
                    # live to the end and blow the register file
                    get_fam_word(fam_member[i][0])
                continue
            if i in split_plan:
                lo_t, hi_t, k_lo, k_hi = split_plan[i]
                if bitpack is not None:
                    lo_x, lo_t = _grouped(lo_t)
                    hi_x, hi_t = _grouped(hi_t)
                else:
                    lo_x = hi_x = ()
                lo = _nsum(lo_t, k_lo, lo_x)
                car = synth(True)
                steps.append(("nshr", lo, None, None, car, 16))
                if hi_t or hi_x or k_hi:
                    hi = _nsum(hi_t, k_hi, hi_x)
                    t_n = synth(True)
                    steps.append(("nadd", hi, car, None, t_n, None))
                else:
                    t_n = car
                splitrep[i] = (lo, t_n)
                continue
            if xt.ops[i] == "shr_k" and xt.args[i][0] in splitrep:
                lo, t_n = splitrep[xt.args[i][0]]
                k = xt.imms[i]
                if k < 16:
                    steps.append(("nshr", lo, None, None, i, k))
                elif k == 16:
                    alias[i] = t_n
                else:
                    steps.append(("nshr", t_n, None, None, i, k - 16))
                continue
            if i in nword_plan:
                its, kc = nword_plan[i]
                extra, rest = _grouped(its)
                acc = _nsum(rest, kc, extra)
                alias[i] = as_node(acc)
                continue
            if i in nroots:
                leaves_n, leaves_w, K2 = nroots[i]
                groups = []
                cur, lo, hi = [], 0, 0
                for x in leaves_n:
                    xlo, xhi = rngx[x]
                    if cur and not (-NM <= lo + xlo and hi + xhi <= NM):
                        groups.append(cur)
                        cur, lo, hi = [], 0, 0
                    cur.append(x)
                    lo += xlo
                    hi += xhi
                if cur:
                    groups.append(cur)
                wparts = [wform(res(x)) for x in leaves_w]
                for grp in groups:
                    acc_n = sres(grp[0])
                    for x in grp[1:]:
                        nid = synth(True)
                        steps.append(("nadd", nform(acc_n),
                                      nform(sres(x)), None, nid, None))
                        acc_n = nid
                    wparts.append(wide_of(acc_n))
                acc = wparts[0]
                for xw in wparts[1:]:
                    nid = synth()
                    steps.append(("add", acc, xw, None, nid, None))
                    acc = nid
                if K2:
                    nid = synth()
                    steps.append(("add_c", acc, ("bank", bank(K2)),
                                  None, nid, None))
                    acc = nid
                alias[i] = acc
                continue
            if i in roots:
                terms, bares, K_acc = [
                    [(sres(x), c) for (x, c) in roots[i][0]],
                    [sres(x) for x in roots[i][1]],
                    roots[i][2]]
                parts = []
                g = 0
                first = True
                while len(terms) - g >= 2:
                    n = 3 if len(terms) - g >= 3 else 2
                    grp = terms[g:g + n]
                    g += n
                    # the additive constant folds into the first dot's
                    # column set pre-Montgomery-scaled: sum(c*x)R^-1 + K
                    # = (sum(c*x) + K*R)R^-1
                    kfold = (K_acc * xt.R) % xt.p if first else 0
                    first = False
                    base = bank_range([c for (_x, c) in grp] + [kfold])
                    nid = synth()
                    steps.append((
                        f"dot{n}_c",
                        res(grp[0][0]), res(grp[1][0]),
                        res(grp[2][0]) if n == 3 else None,
                        nid, base))
                    parts.append(nid)
                if len(terms) - g == 1:
                    x, cv = terms[g]
                    nid = synth()
                    steps.append(("mul_c", res(x), ("bank", bank(cv)),
                                  None, nid, None))
                    parts.append(nid)
                parts.extend(wform(res(x)) if isinstance(res(x), int)
                             else res(x) for x in bares)
                acc = parts[0]
                for x in parts[1:]:
                    nid = synth()
                    steps.append(("add", acc, x, None, nid, None))
                    acc = nid
                if K_acc and first:  # no dot absorbed it (unreachable:
                    nid = synth()    # >=2 terms always makes a dot)
                    steps.append(("add_c", acc, ("bank", bank(K_acc)),
                                  None, nid, None))
                    acc = nid
                alias[i] = acc
                continue
            op = xt.ops[i]
            a = [sres(x) for x in xt.args[i]]
            kinds = [xt.kind[x] for x in a]
            if op == "select" and kinds[0] == "const":
                alias[i] = a[1] if xt.cval[a[0]] else a[2]
                continue
            nrw_i = is_nrw(i)

            # ---- narrow-result ops (comparisons/booleans always) -----
            if op in _CMP:
                xs = [x for x, k in zip(a, kinds) if k != "const"]
                if xs and all(is_nrw(x) for x in xs) and all(
                        nfits(xt.cval[x]) for x, k in zip(a, kinds)
                        if k == "const"):
                    steps.append((op + "_nn", nform(a[0]), nform(a[1]),
                                  None, i, None))
                else:
                    steps.append((op + "_ww", wform(a[0]), wform(a[1]),
                                  None, i, None))
                node_narrow[i] = True
                continue
            if op == "lnot":
                if is_nrw(a[0]):
                    steps.append(("lnot_n", a[0], None, None, i, None))
                else:
                    steps.append(("lnot_w", wform(a[0]), None, None,
                                  i, None))
                node_narrow[i] = True
                continue
            if nrw_i and op in ("mulp", "add", "sub"):
                nop = {"mulp": "nmul", "add": "nadd", "sub": "nsub"}[op]
                steps.append((nop, nform(a[0]), nform(a[1]), None,
                              i, None))
                continue
            if nrw_i and op == "select":
                x1, x2 = nform(a[1]), nform(a[2])
                if kinds[0] != "const" and not is_nrw(a[0]):
                    steps.append(("nsel_w", a[0], x1, x2, i, None))
                else:
                    steps.append(("nsel", nform(a[0]), x1, x2, i, None))
                continue
            if nrw_i and op == "band":
                cargs = [x for x, k in zip(a, kinds) if k == "const"]
                vargs = [x for x, k in zip(a, kinds) if k != "const"]
                if len(vargs) == 2 and all(is_nrw(x) for x in vargs):
                    steps.append(("nband", vargs[0], vargs[1], None,
                                  i, None))
                    continue
                if len(vargs) == 1 and is_nrw(vargs[0]) and cargs:
                    steps.append(("nband", vargs[0], nform(cargs[0]),
                                  None, i, None))
                    continue
                if len(vargs) == 1 and cargs \
                        and xt.cval[cargs[0]] <= (1 << 31) - 1:
                    # wide value masked by a small constant -> narrow
                    steps.append(("nband_w", wform(vargs[0]), None, None,
                                  i, bank(xt.cval[cargs[0]])))
                    continue
                node_narrow[i] = False
                nrw_i = False  # fall through to the wide band
            if nrw_i and op in ("bor", "bxor"):
                steps.append(({"bor": "nbor", "bxor": "nbxor"}[op],
                              nform(a[0]), nform(a[1]), None, i, None))
                continue
            if nrw_i and op in ("shl_k", "shr_k"):
                steps.append(({"shl_k": "nshl", "shr_k": "nshr"}[op],
                              nform(a[0]), None, None, i, xt.imms[i]))
                continue
            if nrw_i and op == "idiv":
                # both operands proven nonneg int32 (ranges.py gate):
                # plain int32 division, idiv(a, 0) = 0
                steps.append(("nidiv", nform(a[0]), nform(a[1]), None,
                              i, None))
                continue

            # ---- wide ops ---------------------------------------------
            if op == "mulp":
                if kinds[0] == "const":
                    a = [a[1], a[0]]
                    kinds = [kinds[1], kinds[0]]
                if xt.plain:
                    # goldilocks: fold-reduced plain product (gl_mul)
                    if kinds[1] == "const":
                        steps.append(("gmul_c", wform(a[0]),
                                      ("bank", bank(xt.cval[a[1]])),
                                      None, i, None))
                    else:
                        steps.append(("gmul", wform(a[0]), wform(a[1]),
                                      None, i, None))
                    continue
                # plain product on the wide lane; by a constant it is a
                # single montmul with the constant pre-scaled by R:
                # montmul(a, cR) = a*c.  Variable*variable costs two.
                if kinds[1] == "const":
                    cr = (xt.cval[a[1]] * xt.R) % xt.p
                    steps.append(("mul_c", wform(a[0]),
                                  ("bank", bank(cr)), None, i, None))
                    continue
                t = synth()
                steps.append(("mul", wform(a[0]), wform(a[1]),
                              None, t, None))
                steps.append(("mul_r2", t, None, None, i, None))
                continue
            if op in ("shl_k", "shr_k"):
                steps.append(({"shl_k": "shl_kw", "shr_k": "shr_kw"}[op],
                              wform(a[0]), None, None, i, xt.imms[i]))
                continue
            if op in _C_VARIANTS:
                ops_c = _C_VARIANTS[op]
                if op in ("mul", "add") and kinds[0] == "const":
                    a = [a[1], a[0]]
                    kinds = [kinds[1], kinds[0]]
                if kinds[1] == "const":
                    v = xt.cval[a[1]]
                    if op == "mul" and v == one_v:
                        steps.append(("mul_one", wform(a[0]), None, None,
                                      i, None))
                    elif op == "mul" and v == r2_v:
                        steps.append(("mul_r2", wform(a[0]), None, None,
                                      i, None))
                    else:
                        steps.append((ops_c, wform(a[0]),
                                      ("bank", bank(v)), None, i, None))
                    continue
                if op == "sub" and kinds[0] == "const":
                    steps.append(("csub_c", wform(a[1]),
                                  ("bank", bank(xt.cval[a[0]])),
                                  None, i, None))
                    continue
                steps.append((op, wform(a[0]), wform(a[1]), None,
                              i, None))
                continue
            if op not in _VV_OPS:
                raise UnsupportedTapeOp(
                    f"op '{op}' not supported by the interpreter kernel")
            norm = [wform(x) for x in a]
            pad = norm + [None] * (3 - len(norm))
            steps.append((op, pad[0], pad[1], pad[2], i, None))

        if os.environ.get("CTPU_DEBUG"):
            print("# rest terms:", dict(_dbg_rest.most_common(10)))

        # narrow witness values stream out RAW (int32 emission buffer,
        # limb conversion happens vectorized outside the kernel), so no
        # widen steps are needed for emission — only alias resolution.
        self.xt.out_ids = [res(o) for o in xt.out_ids]
        out_set = set(x for x in self.xt.out_ids
                      if xt.kind[x] == "compute")

        # packed-family witness members emit ONE packed word row; the
        # gather unpacks (row >> bit) & 1 per witness index (bit_src)
        bit_src = {}
        if bitpack is not None:
            for nid in list(out_set):
                if nid in fam_member:
                    fi, p = fam_member[nid]
                    bit_src[nid] = (get_fam_word(fi), p)
            out_set -= set(bit_src)
            out_set.update(w for (w, _p) in bit_src.values())
        self._bit_src = bit_src

        # --- deferred from-Mont emission pass ---------------------------
        # Poseidon-class circuits spend ~40% of their steps on
        # emission-only Montgomery output conversions (montmul(x, 1) =
        # REDC(x)); the reference's runtimes pay the same conversion
        # per witness store (Fr_toLongNormal, main.cpp:211-212).  Here
        # each such mul_one step is DELETED: the producer's Montgomery
        # row is emitted raw and the kernel REDCs the whole emission
        # block once per chunk as a single (K+1, 8, bb)-slab op under a
        # per-row mask — one traced body, no per-step dispatch, no
        # extra HBM traffic (the block is still in VMEM).
        defer_src = {}      # conversion node -> producer node
        producers = set()
        if not xt.plain:
            used = {}
            for (op, a, b, c, _i, _aux) in steps:
                for x in (a, b, c):
                    if isinstance(x, int):
                        used[x] = used.get(x, 0) + 1
            kept = []
            for st in steps:
                (op, a, b, _c, i, _aux) = st
                if (op == "mul_one" and i in out_set
                        and used.get(i, 0) == 0
                        and isinstance(a, int)
                        and xt.kind[a] == "compute"
                        and a not in out_set
                        and not node_narrow.get(a, False)):
                    defer_src[i] = a
                    out_set.add(a)
                    producers.add(a)
                    continue
                kept.append(st)
            steps = kept
        self.defer_src = defer_src

        # --- witness passthrough copies ---------------------------------
        # input/const witness rows get explicit copy steps so EVERY
        # witness value is an emission row: the device-side unblock
        # gather then reads one homogeneous bank (no concatenated
        # input/const side banks, which cost a full extra HBM pass).
        # consts ride the narrow stream ONLY when the circuit has no
        # wide emissions (SHA-class): on a wide circuit a single
        # narrow const row (the witness's constant-1 wire) would make
        # idx_n non-empty and knock the whole witness off the Pallas
        # fast gather — ~20 ms of XLA take/reshape glue on
        # Poseidon2-64k (r5 profile; this was a silent r4 regression)
        has_wide_emit = any(st[4] in out_set
                            and st[0] not in _NARROW_RESULT
                            for st in steps)
        for nid in dict.fromkeys(self.xt.out_ids):
            k = xt.kind[nid]
            if k == "compute":
                continue
            if k == "const":
                v = xt.cval[nid]
                if nfits(v) and not has_wide_emit:
                    # int32-fitting consts on the narrow stream: a
                    # wide copy would open a wide emission buffer
                    # (2(K+2)L VMEM tiles) just for them on otherwise
                    # pure-narrow circuits (SHA)
                    steps.append(("ncopy", ("nmat", nmaterialize(v)),
                                  None, None, nid, None))
                else:
                    steps.append(("copyw", ("mat", materialize(v)),
                                  None, None, nid, None))
            elif xt.iidx[nid] in self.nin_of:
                steps.append(("ncopy", nid, None, None, nid, None))
            else:
                steps.append(("copyw", nid, None, None, nid, None))
            out_set.add(nid)

        # DCE: packing replaces whole per-bit step chains (the shr/band
        # extraction scaffolding feeding only packed gadgets goes dead)
        needed = set(out_set)
        kept_rev = []
        for st in reversed(steps):
            if st[4] in needed:
                kept_rev.append(st)
                for x in (st[1], st[2], st[3]):
                    if isinstance(x, int):
                        needed.add(x)
        steps = kept_rev[::-1]

        if os.environ.get("CTPU_DEBUG"):
            import collections as _c2
            n_orig0 = next((k for k in range(len(xt.ops))
                            if xt.ops[k] == "_tmp"), len(xt.ops))
            cnt = _c2.Counter(
                (st[0], "synth" if st[4] >= n_orig0 else "orig")
                for st in steps)
            print("# post-DCE steps:", dict(cnt.most_common(14)))

        steps = self._schedule_runs(steps)

        # --- register allocation ---------------------------------------
        # wide regs: [wide inputs][materialized consts][dynamic][trash]
        # narrow regs: [narrow inputs][narrow consts][dynamic][trash]
        n_win = len(self.win_of)
        n_nin = len(self.nin_of)
        n_fixed = n_win + len(mat_ix)
        self.mat_loads = [
            (n_win + r, tuple(int(x) for x in int_to_limbs(v, L)))
            for v, r in sorted(mat_ix.items(), key=lambda kv: kv[1])
        ]
        n_nfixed = n_nin + len(nmat_ix)
        self.nmat_loads = sorted(
            ((n_nin + r, sv) for sv, r in nmat_ix.items()),
            key=lambda kv: kv[0])

        narrow_ops = sorted({op for (op, *_r) in steps
                             if op in _NARROW_RESULT})
        wide_ops = sorted({op for (op, *_r) in steps
                           if op not in _NARROW_RESULT})
        self.opset_n, self.opset_w = narrow_ops, wide_ops
        self.n_narrow_ops = len(narrow_ops)
        op_id = {op: k for k, op in enumerate(narrow_ops)}
        for k, op in enumerate(wide_ops):
            op_id[op] = self.n_narrow_ops + k

        last_use = {}
        for t, (_op, a, b, c, _i, _aux) in enumerate(steps):
            for x in (a, b, c):
                if isinstance(x, int):
                    last_use[x] = t
        reg_of, nreg_of = {}, {}
        free_w, free_n = [], []
        n_dyn_w = n_dyn_n = 0
        expire = [[] for _ in range(len(steps) + 1)]

        def operand_reg(x, want_narrow):
            if isinstance(x, tuple):
                if x[0] == "bank":
                    return x[1]
                if x[0] == "mat":
                    return n_win + x[1]
                return n_nin + x[1]  # ("nmat", slot)
            if xt.kind[x] == "input":
                idx = xt.iidx[x]
                return (self.nin_of[idx] if want_narrow
                        else self.win_of[idx])
            return nreg_of[x] if want_narrow else reg_of[x]

        table = np.zeros((max(len(steps), 1), 7), np.int32)

        # emission buffers: wide rows and RAW narrow int32 rows stream
        # through separate chunked blocks; size each to the tape so the
        # unused stream costs ~nothing (Poseidon: KN=0; SHA: K=0)
        n_wout = n_nout = 0
        for (op, _a, _b, _c, i, _x) in steps:
            if i in out_set:
                if op in _NARROW_RESULT:
                    n_nout += 1
                else:
                    n_wout += 1
        K = min(self.K, n_wout)
        KN = min(self.KN, n_nout)
        self.K, self.KN = K, KN

        # chunking by emission count; a chunk also never exceeds
        # max_call_steps so multi-call paging can always split on a
        # chunk boundary (long emission-free stretches otherwise made
        # single calls whose tables blow the SMEM budget)
        starts = [0]
        emit_w = emit_n = 0
        chunk = 0
        wit_rows = {}    # node -> (chunk, row) in the wide stream
        wit_rows_n = {}  # node -> (chunk, row) in the narrow stream
        mont_rows = set()  # (chunk, row): Montgomery rows REDC'd in-kernel
        for t, (op, a, b, c, i, aux) in enumerate(steps):
            for (fl, r) in expire[t]:
                (free_n if fl else free_w).append(r)
            dst_narrow = op in _NARROW_RESULT
            emits = i in out_set
            if (emits and ((not dst_narrow and emit_w == K)
                           or (dst_narrow and emit_n == KN))) \
                    or t - starts[-1] >= self.max_call_steps:
                starts.append(t)
                chunk += 1
                emit_w = emit_n = 0
            files = _OPERAND_FILES.get(op, ("w", "w", "w"))
            cols = []
            for x, f in zip((a, b, c), files):
                if x is None:
                    cols.append(0)
                else:
                    cols.append(operand_reg(x, f == "n"))
            # destination (passthrough-copy steps of input/const nodes
            # never allocate: operands resolve to input/const slots)
            if i in last_use and last_use[i] > t \
                    and xt.kind[i] == "compute":
                if dst_narrow:
                    r = free_n.pop() if free_n else n_nfixed + n_dyn_n
                    if r == n_nfixed + n_dyn_n:
                        n_dyn_n += 1
                    nreg_of[i] = r
                else:
                    r = free_w.pop() if free_w else n_fixed + n_dyn_w
                    if r == n_fixed + n_dyn_w:
                        n_dyn_w += 1
                    reg_of[i] = r
                expire[last_use[i] + 1].append((dst_narrow, r))
                dst = r
            else:
                dst = -1  # trash, patched below
            if emits and dst_narrow:
                wit_rows_n[i] = (chunk, emit_n)
                em = emit_n
                emit_n += 1
            elif emits:
                wit_rows[i] = (chunk, emit_w)
                if i in producers:
                    mont_rows.add((chunk, emit_w))
                em = emit_w
                emit_w += 1
            else:
                em = KN if dst_narrow else K
            table[t] = (op_id[op], cols[0], cols[1], cols[2], dst, em,
                        aux if aux is not None else 0)
        starts.append(len(steps))
        self.n_win, self.n_nin = n_win, n_nin
        self.n_regs = n_fixed + n_dyn_w + 1    # + wide trash
        self.n_nregs = n_nfixed + n_dyn_n + 1  # + narrow trash
        if self.n_regs > max_regs:
            raise UnsupportedTapeOp(
                f"register file too large ({self.n_regs} > {max_regs})")
        if self.n_nregs > 16 * max_regs:
            raise UnsupportedTapeOp(
                f"narrow register file too large ({self.n_nregs})")
        for t, (op, *_r) in enumerate(steps):
            if table[t, 4] == -1:
                table[t, 4] = (self.n_nregs - 1 if op in _NARROW_RESULT
                               else self.n_regs - 1)
        self.table = table
        self.starts = np.asarray(starts, np.int32)
        self.n_chunks = len(starts) - 1
        self.n_steps = len(steps)
        # per-emission-row Montgomery flags for the in-kernel trailing
        # REDC slab (deferred from-Mont pass above)
        mont_tab = np.zeros((self.n_chunks * (K + 1),), np.int32)
        for (g, r) in mont_rows:
            mont_tab[g * (K + 1) + r] = 1
        self.mont_tab = mont_tab
        self.mont_any = bool(mont_tab.any())
        self.n_mont_rows = int(mont_tab.sum())
        # run tables: maximal same-opcode step ranges within a chunk;
        # the kernel dispatches ONE lax.switch per run
        starts_at = {s: c for c, s in enumerate(starts[:-1])}
        r_op, r_s0 = [], []
        rstarts = [0] * len(starts)
        prev = None
        for t, st in enumerate(steps):
            if t in starts_at or st[0] != prev:
                if t in starts_at:
                    rstarts[starts_at[t]] = len(r_op)
                r_op.append(op_id[st[0]])
                r_s0.append(t)
                prev = st[0]
        r_s0.append(len(steps))
        rstarts[-1] = len(r_op)
        if not r_op:
            r_op, r_s0 = [0], [0, 0]
        self.r_op = np.asarray(r_op, np.int32)
        self.r_s0 = np.asarray(r_s0, np.int32)
        self.rstarts = np.asarray(rstarts, np.int32)
        self.n_runs = len(r_op)
        # --- instruction-table paging: SMEM holds ~1MB, so tapes are
        # split into CALLS of <= max_call_steps; the register files hand
        # off through HBM between calls.  All calls share one padded
        # table shape (one Mosaic kernel).
        MAXS = self.max_call_steps
        calls = []  # (chunk_lo, chunk_hi, s0, s1)
        lo = 0
        for c in range(self.n_chunks):
            if starts[c + 1] - starts[lo] > MAXS and c > lo:
                calls.append((lo, c, starts[lo], starts[c]))
                lo = c
        calls.append((lo, self.n_chunks, starts[lo], starts[-1]))
        self.calls = calls
        self.call_steps = max((s1 - s0) for (_a, _b, s0, s1) in calls)
        self.call_chunks = max((b - a) for (a, b, _s, _t) in calls)
        self.call_runs = max((int(rstarts[b]) - int(rstarts[a]))
                             for (a, b, _s, _t) in calls)
        # const bank (scalar-prefetched, int32)
        if not bank_vals:
            bank_vals.append(0)
        cb = np.zeros((len(bank_vals), L), np.int32)
        for r, v in enumerate(bank_vals):
            cb[r] = int_to_limbs(v, L).astype(np.int32)
        self.cbank = cb
        # witness source map (everything is an emission row by
        # construction — the passthrough-copy pass above; const/input
        # fallbacks retained for the zero-step tape edge case)
        self.wit_src = []
        for nid in self.xt.out_ids:
            if nid in bit_src:
                w, p = bit_src[nid]
                self.wit_src.append(("emitb", *wit_rows_n[w], p))
            elif nid in wit_rows_n:
                self.wit_src.append(("emitn", *wit_rows_n[nid]))
            elif nid in defer_src:
                # deferred conversion: the producer's row IS canonical
                # after the kernel's trailing REDC slab
                self.wit_src.append(("emit", *wit_rows[defer_src[nid]]))
            elif nid in wit_rows:
                self.wit_src.append(("emit", *wit_rows[nid]))
            elif xt.kind[nid] == "const":
                self.wit_src.append(("const", xt.cval[nid]))
            else:
                self.wit_src.append(("input", xt.iidx[nid]))

    # ------------------------------------------------------------------
    def _schedule_runs(self, steps):
        """Reorder steps into same-opcode RUNS (greedy list schedule).

        The kernel dispatches one lax.switch per run (not per step), so
        long runs amortize interpreter dispatch — bit-parallel circuits
        (SHA: 32 independent per-bit ops per word op) produce wide
        ready sets.  Greedy rule: among ready steps, emit the whole
        ready set of the opcode that currently has the most ready
        steps; newly-readied steps of the same opcode extend the run
        (runs are recomputed from the final order).  Always a valid
        topological order."""
        n = len(steps)
        if n == 0:
            return steps
        kind = self.xt.kind
        prod = {}
        for t, st in enumerate(steps):
            if kind[st[4]] == "compute":
                prod[st[4]] = t
        consumers = [[] for _ in range(n)]
        indeg = [0] * n
        for t, st in enumerate(steps):
            seen = set()
            for x in st[1:4]:
                if isinstance(x, int) and x in prod and prod[x] != t \
                        and prod[x] not in seen:
                    seen.add(prod[x])
                    consumers[prod[x]].append(t)
                    indeg[t] += 1
        # ALAP levels: how late each step may run.  Emission-only steps
        # pin right after their producers (not the tape end — keeping
        # their operands live to the end would blow the register file).
        alap = [0] * n
        for t in range(n - 1, -1, -1):
            if consumers[t]:
                alap[t] = min(alap[t2] for t2 in consumers[t]) - 1
        for t in range(n):
            if not consumers[t]:
                lv = None
                for x in steps[t][1:4]:
                    if isinstance(x, int) and x in prod:
                        lx = alap[prod[x]]
                        lv = lx if lv is None else max(lv, lx)
                alap[t] = 0 if lv is None else lv + 1
        # list schedule: always serve the most-urgent opcode class, and
        # take every ready step of that opcode within an ALAP horizon —
        # long same-op runs without letting far-future work (e.g. SHA
        # weight products for rounds 7-16 ahead) stretch liveness.
        import heapq
        HORIZON = 4
        heaps = {}
        for t in range(n):
            if indeg[t] == 0:
                heaps.setdefault(steps[t][0], []).append((alap[t], t))
        for h in heaps.values():
            heapq.heapify(h)
        order = []
        while heaps:
            op = min(heaps, key=lambda o: heaps[o][0])
            h = heaps[op]
            lim = h[0][0] + HORIZON
            batch = []
            while h and h[0][0] < lim:
                batch.append(heapq.heappop(h)[1])
            if not h:
                del heaps[op]
            batch.sort()
            order.extend(batch)
            for t in batch:
                for t2 in consumers[t]:
                    indeg[t2] -= 1
                    if indeg[t2] == 0:
                        h2 = heaps.get(steps[t2][0])
                        if h2 is None:
                            h2 = heaps[steps[t2][0]] = []
                        heapq.heappush(h2, (alap[t2], t2))
        return [steps[t] for t in order]

    # ------------------------------------------------------------------
    def _reorder(self, comp, r2_v):
        """Hoist Montgomery-conversion muls (by 1 or R^2) to right after
        their producer.  DomainTape materializes output conversions at
        the tape tail, which otherwise keeps every Montgomery witness
        value live to the end (measured 320 registers on Poseidon2 vs
        ~30 after hoisting)."""
        xt = self.xt
        comp_set = set(comp)
        attach, head = {}, []
        conv = set()
        for i in comp:
            if xt.ops[i] != "mul":
                continue
            var = [x for x in xt.args[i] if xt.kind[x] != "const"]
            cst = [x for x in xt.args[i] if xt.kind[x] == "const"]
            if len(var) == 1 and cst and xt.cval[cst[0]] in (1, r2_v):
                conv.add(i)
                if var[0] in comp_set:
                    attach.setdefault(var[0], []).append(i)
                else:
                    head.append(i)
        order = []

        def place(i):
            order.append(i)
            for c in attach.get(i, ()):
                place(c)

        for i in head:
            place(i)
        for i in comp:
            if i not in conv:
                place(i)
        return order

    # ------------------------------------------------------------------
    def mixed_layout(self):
        """(narrow witness indices, wide witness indices) matching the
        row order of run_mixed's two arrays."""
        _, idx, _ = mixed_split(self.wit_src, self.nin_of, self.win_of,
                                self.K, self.KN, self.n_chunks)
        return idx

    def plan_arrays(self):
        """Every table the executors need, as numpy arrays and ints."""
        return {
            "table": self.table,
            "r_op": self.r_op,
            "r_s0": self.r_s0,
            "rstarts": self.rstarts,
            "cbank": self.cbank,
            "mont_tab": self.mont_tab,
            "mat_loads": self.mat_loads,
            "nmat_loads": self.nmat_loads,
            "wit_src": self.wit_src,
            "win_of": self.win_of,
            "nin_of": self.nin_of,
            "K": self.K,
            "KN": self.KN,
            "n_regs": self.n_regs,
            "n_nregs": self.n_nregs,
            "n_chunks": self.n_chunks,
            "calls": self.calls,
            "opset_n": self.opset_n,
            "opset_w": self.opset_w,
        }
