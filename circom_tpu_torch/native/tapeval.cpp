// Native witness-tape interpreter.
//
// C++ counterpart of the reference's emitted C++ witness calculator
// (code_producers/src/c_elements/common/calcwit.cpp + fr.asm): evaluates
// the domain-resolved SSA tape (same instruction stream the JAX backend
// executes) over 4x64-bit Montgomery field arithmetic, batched over
// witnesses with OpenMP (the reference parallelizes with std::thread per
// `parallel` component, calcwit.hpp:33-38; here witnesses are
// embarrassingly parallel).
//
// Field: any prime < 2^256. Values canonical ("NORM") or Montgomery
// ("MONT", R = 2^256) — the tape's to_mont/from_mont ops switch domains.
// Comparison ops use the signed convention (values > p/2 are negative,
// circom_algebra/src/modular_arithmetic.rs:154-213); shifts are
// pre-normalized immediates; idiv/mod implement full 256-bit division.
//
// Build: g++ -O3 -shared -fPIC -fopenmp tapeval.cpp -o libtapeval.so

#include <cstdint>
#include <cstring>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

constexpr int NL = 4;  // 4 x 64-bit limbs

struct Fe {
    u64 v[NL];
};

struct Field {
    Fe p;
    Fe r2;        // R^2 mod p
    Fe one_mont;  // R mod p
    Fe half;      // p/2
    Fe mask;      // 2^bits(p) - 1
    u64 n0inv;    // -p^-1 mod 2^64
    int bits;
};

inline bool geq(const Fe &a, const Fe &b) {
    for (int i = NL - 1; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

inline void sub_raw(Fe &r, const Fe &a, const Fe &b) {
    u128 borrow = 0;
    for (int i = 0; i < NL; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

inline void add_mod(Fe &r, const Fe &a, const Fe &b, const Field &f) {
    u128 carry = 0;
    for (int i = 0; i < NL; ++i) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        r.v[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(r, f.p)) sub_raw(r, r, f.p);
}

inline void sub_mod(Fe &r, const Fe &a, const Fe &b, const Field &f) {
    u128 borrow = 0;
    Fe t;
    for (int i = 0; i < NL; ++i) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        t.v[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < NL; ++i) {
            u128 s = (u128)t.v[i] + f.p.v[i] + carry;
            t.v[i] = (u64)s;
            carry = s >> 64;
        }
    }
    r = t;
}

// Montgomery CIOS multiply: r = a*b*R^-1 mod p
inline void mont_mul(Fe &r, const Fe &a, const Fe &b, const Field &f) {
    u64 t[NL + 2] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < NL; ++i) {
        u128 carry = 0;
        for (int j = 0; j < NL; ++j) {
            u128 cur = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 s = (u128)t[NL] + carry;
        t[NL] = (u64)s;
        t[NL + 1] = (u64)(s >> 64);
        u64 m = t[0] * f.n0inv;
        carry = 0;
        {
            u128 cur = (u128)t[0] + (u128)m * f.p.v[0];
            carry = cur >> 64;
        }
        for (int j = 1; j < NL; ++j) {
            u128 cur = (u128)t[j] + (u128)m * f.p.v[j] + carry;
            t[j - 1] = (u64)cur;
            carry = cur >> 64;
        }
        u128 s2 = (u128)t[NL] + carry;
        t[NL - 1] = (u64)s2;
        t[NL] = t[NL + 1] + (u64)(s2 >> 64);
        t[NL + 1] = 0;
    }
    Fe res;
    for (int i = 0; i < NL; ++i) res.v[i] = t[i];
    if (t[NL] || geq(res, f.p)) sub_raw(res, res, f.p);
    r = res;
}

inline void pow_mont(Fe &r, const Fe &a, const Fe &e, const Field &f) {
    Fe acc = f.one_mont;
    bool started = false;
    for (int i = NL - 1; i >= 0; --i) {
        for (int b = 63; b >= 0; --b) {
            if (started) mont_mul(acc, acc, acc, f);
            if ((e.v[i] >> b) & 1) {
                if (started) {
                    mont_mul(acc, acc, a, f);
                } else {
                    acc = a;
                    started = true;
                }
            }
        }
    }
    r = started ? acc : f.one_mont;
}

inline void inv_mont(Fe &r, const Fe &a, const Field &f) {
    Fe pm2;
    u128 borrow = 2;
    for (int i = 0; i < NL; ++i) {
        u128 d = (u128)f.p.v[i] - (u64)borrow - (i == 0 ? 0 : 0);
        if (i == 0) {
            d = (u128)f.p.v[0] - 2;
            pm2.v[0] = (u64)d;
            borrow = (d >> 64) ? 1 : 0;
        } else {
            d = (u128)f.p.v[i] - borrow;
            pm2.v[i] = (u64)d;
            borrow = (d >> 64) ? 1 : 0;
        }
    }
    pow_mont(r, a, pm2, f);
}

inline bool is_zero(const Fe &a) {
    return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

inline bool lt_raw(const Fe &a, const Fe &b) {
    for (int i = NL - 1; i >= 0; --i) {
        if (a.v[i] != b.v[i]) return a.v[i] < b.v[i];
    }
    return false;
}

// signed convention: a > p/2 means negative
inline bool is_neg(const Fe &a, const Field &f) { return lt_raw(f.half, a); }

inline bool lt_signed(const Fe &a, const Fe &b, const Field &f) {
    bool na = is_neg(a, f), nb = is_neg(b, f);
    if (na != nb) return na;
    return lt_raw(a, b);
}

inline void set_bool(Fe &r, bool b) {
    r.v[0] = b ? 1 : 0;
    r.v[1] = r.v[2] = r.v[3] = 0;
}

inline void shr_k(Fe &r, const Fe &a, unsigned k) {
    if (k >= 256) { r.v[0] = r.v[1] = r.v[2] = r.v[3] = 0; return; }
    unsigned q = k / 64, s = k % 64;
    for (int i = 0; i < NL; ++i) {
        u64 lo = (i + (int)q < NL) ? a.v[i + q] : 0;
        u64 hi = (i + (int)q + 1 < NL) ? a.v[i + q + 1] : 0;
        r.v[i] = s ? ((lo >> s) | (hi << (64 - s))) : lo;
    }
}

inline void shl_k(Fe &r, const Fe &a, unsigned k, const Field &f) {
    Fe t;
    if (k >= 256) { t.v[0] = t.v[1] = t.v[2] = t.v[3] = 0; }
    else {
        unsigned q = k / 64, s = k % 64;
        for (int i = NL - 1; i >= 0; --i) {
            u64 lo = (i - (int)q >= 0) ? a.v[i - q] : 0;
            u64 hi = (i - (int)q - 1 >= 0) ? a.v[i - q - 1] : 0;
            t.v[i] = s ? ((lo << s) | (hi >> (64 - s))) : lo;
        }
    }
    for (int i = 0; i < NL; ++i) t.v[i] &= f.mask.v[i];
    if (geq(t, f.p)) sub_raw(t, t, f.p);
    r = t;
}

// full 256-bit division: q = a / b, m = a % b (b != 0)
inline void divmod_raw(Fe &q, Fe &m, const Fe &a, const Fe &b) {
    q.v[0] = q.v[1] = q.v[2] = q.v[3] = 0;
    m = q;
    for (int i = 255; i >= 0; --i) {
        // m = (m << 1) | bit_i(a)
        for (int j = NL - 1; j > 0; --j)
            m.v[j] = (m.v[j] << 1) | (m.v[j - 1] >> 63);
        m.v[0] = (m.v[0] << 1) | ((a.v[i / 64] >> (i % 64)) & 1);
        if (geq(m, b)) {
            sub_raw(m, m, b);
            q.v[i / 64] |= (u64)1 << (i % 64);
        }
    }
}

enum Op {
    OP_CONST = 0, OP_INPUT, OP_ADD, OP_SUB, OP_MUL, OP_DIV, OP_NEG,
    OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NEQ,
    OP_LAND, OP_LOR, OP_LNOT, OP_BAND, OP_BOR, OP_BXOR, OP_BNOT,
    OP_SHL_K, OP_SHR_K, OP_POW_K, OP_SELECT, OP_TO_MONT, OP_FROM_MONT,
    OP_IDIV, OP_MOD, OP_MULP,
};

// narrow int64 fast path: the analog of the reference FrElement's
// short-value representation (c_elements/bn128/fr.hpp:12-26 SHORT
// type) with COMPILE-TIME classification: nodes proven
// int32-representable by the range analysis (backend/ranges.py, same
// proof the TPU narrow lane uses) hold a signed int64 in v[0] and run
// plain integer ops — a bit gadget costs 1 multiply instead of a 4x64
// Montgomery multiply.
inline int64_t fe_to_i64(const Fe &x, const Field &f) {
    // canonical -> signed value (value - p when above p/2); callers
    // are range-proven to fit
    if (lt_raw(f.half, x)) {
        Fe t;
        sub_raw(t, f.p, x);
        return -(int64_t)t.v[0];
    }
    return (int64_t)x.v[0];
}

inline void i64_to_fe(Fe &r, int64_t v, const Field &f) {
    if (v >= 0) {
        r.v[0] = (u64)v; r.v[1] = r.v[2] = r.v[3] = 0;
    } else {
        Fe t = {{(u64)(-v), 0, 0, 0}};
        sub_raw(r, f.p, t);
    }
}

struct Program {
    Field f;
    int n_ops, n_inputs, n_outputs;
    std::vector<int32_t> op;
    std::vector<int32_t> a, b, c;
    std::vector<int64_t> imm;      // const-table index or shift/exponent
    std::vector<Fe> consts;        // pre-domain-adjusted constants
    std::vector<int32_t> outputs;  // node ids
    std::vector<uint8_t> nres;     // result on the narrow int64 path
    std::vector<uint8_t> na, nb, nc;  // operand narrowness
};

}  // namespace

extern "C" {

void *tv_create(const u64 *p_limbs, const u64 *r2, const u64 *one_mont,
                const u64 *half, const u64 *mask, u64 n0inv, int bits,
                int n_ops, const int32_t *op, const int32_t *a,
                const int32_t *b, const int32_t *c, const int64_t *imm,
                int n_consts, const u64 *consts, int n_inputs,
                int n_outputs, const int32_t *outputs,
                const uint8_t *nres, const uint8_t *na,
                const uint8_t *nb, const uint8_t *nc) {
    Program *prog = new Program();
    std::memcpy(prog->f.p.v, p_limbs, 32);
    std::memcpy(prog->f.r2.v, r2, 32);
    std::memcpy(prog->f.one_mont.v, one_mont, 32);
    std::memcpy(prog->f.half.v, half, 32);
    std::memcpy(prog->f.mask.v, mask, 32);
    prog->f.n0inv = n0inv;
    prog->f.bits = bits;
    prog->n_ops = n_ops;
    prog->n_inputs = n_inputs;
    prog->n_outputs = n_outputs;
    prog->op.assign(op, op + n_ops);
    prog->a.assign(a, a + n_ops);
    prog->b.assign(b, b + n_ops);
    prog->c.assign(c, c + n_ops);
    prog->imm.assign(imm, imm + n_ops);
    prog->consts.resize(n_consts);
    std::memcpy(prog->consts.data(), consts, (size_t)n_consts * 32);
    prog->outputs.assign(outputs, outputs + n_outputs);
    if (nres) {
        prog->nres.assign(nres, nres + n_ops);
        prog->na.assign(na, na + n_ops);
        prog->nb.assign(nb, nb + n_ops);
        prog->nc.assign(nc, nc + n_ops);
    } else {
        prog->nres.assign(n_ops, 0);
        prog->na.assign(n_ops, 0);
        prog->nb.assign(n_ops, 0);
        prog->nc.assign(n_ops, 0);
    }
    return prog;
}

void tv_destroy(void *h) { delete (Program *)h; }

// inputs: (batch, n_inputs, 4) u64 row-major; outputs: (batch, n_outputs, 4)
int tv_run_batch(void *h, int batch, const u64 *inputs, u64 *outputs) {
    Program *prog = (Program *)h;
    const Field &f = prog->f;
    int n = prog->n_ops;
    int err = 0;
#pragma omp parallel
    {
    std::vector<Fe> regs((size_t)n);  // hoisted: one buffer per thread
#pragma omp for schedule(static)
    for (int w = 0; w < batch; ++w) {
        const u64 *in = inputs + (size_t)w * prog->n_inputs * NL;
        for (int i = 0; i < n; ++i) {
            Fe &r = regs[i];
            if (prog->nres[i]) {
                // narrow int64 path (signed convention = the circom
                // comparison convention, so compares are plain)
                const Fe &Ar = regs[prog->a[i]];
                const Fe &Br = regs[prog->b[i]];
                const Fe &Cr = regs[prog->c[i]];
                bool an = prog->na[i], bn = prog->nb[i];
                int64_t av = an ? (int64_t)Ar.v[0] : 0;
                int64_t bv = bn ? (int64_t)Br.v[0] : 0;
                int64_t res = 0;
                switch (prog->op[i]) {
                    case OP_ADD:
                        res = (an ? av : fe_to_i64(Ar, f))
                            + (bn ? bv : fe_to_i64(Br, f));
                        break;
                    case OP_SUB:
                        res = (an ? av : fe_to_i64(Ar, f))
                            - (bn ? bv : fe_to_i64(Br, f));
                        break;
                    case OP_MULP:
                        res = (an ? av : fe_to_i64(Ar, f))
                            * (bn ? bv : fe_to_i64(Br, f));
                        break;
                    case OP_NEG:
                        res = -(an ? av : fe_to_i64(Ar, f));
                        break;
                    case OP_BAND:
                        res = (int64_t)(Ar.v[0] & Br.v[0]);
                        break;
                    case OP_BOR:
                        res = (int64_t)(Ar.v[0] | Br.v[0]);
                        break;
                    case OP_BXOR:
                        res = (int64_t)(Ar.v[0] ^ Br.v[0]);
                        break;
                    case OP_SHL_K:
                        res = (an ? av : fe_to_i64(Ar, f))
                            << (unsigned)prog->imm[i];
                        break;
                    case OP_SHR_K:
                        res = (an ? av : fe_to_i64(Ar, f))
                            >> (unsigned)prog->imm[i];
                        break;
                    case OP_SELECT: {
                        bool cond = an ? (av != 0) : !is_zero(Ar);
                        res = cond
                            ? (bn ? bv : fe_to_i64(Br, f))
                            : (prog->nc[i] ? (int64_t)Cr.v[0]
                                           : fe_to_i64(Cr, f));
                        break;
                    }
                    case OP_IDIV: {
                        // narrow gate proves both operands nonneg
                        // (backend/ranges.py); by-zero mirrors the
                        // wide path's error semantics
                        int64_t aa = an ? av : fe_to_i64(Ar, f);
                        int64_t bb = bn ? bv : fe_to_i64(Br, f);
                        if (bb == 0) { err = 1; res = 0; break; }
                        res = aa / bb;
                        break;
                    }
                    case OP_LNOT:
                        res = an ? (av == 0) : is_zero(Ar);
                        break;
                    case OP_LAND:
                        res = (an ? av != 0 : !is_zero(Ar))
                            && (bn ? bv != 0 : !is_zero(Br));
                        break;
                    case OP_LOR:
                        res = (an ? av != 0 : !is_zero(Ar))
                            || (bn ? bv != 0 : !is_zero(Br));
                        break;
                    case OP_EQ: case OP_NEQ: case OP_LT:
                    case OP_LE: case OP_GT: case OP_GE: {
                        bool t;
                        if (an && bn) {
                            switch (prog->op[i]) {
                                case OP_EQ: t = av == bv; break;
                                case OP_NEQ: t = av != bv; break;
                                case OP_LT: t = av < bv; break;
                                case OP_LE: t = av <= bv; break;
                                case OP_GT: t = av > bv; break;
                                default: t = av >= bv; break;
                            }
                        } else {
                            Fe Aw, Bw;
                            if (an) i64_to_fe(Aw, av, f); else Aw = Ar;
                            if (bn) i64_to_fe(Bw, bv, f); else Bw = Br;
                            switch (prog->op[i]) {
                                case OP_EQ:
                                    t = !std::memcmp(Aw.v, Bw.v, 32);
                                    break;
                                case OP_NEQ:
                                    t = std::memcmp(Aw.v, Bw.v, 32) != 0;
                                    break;
                                case OP_LT: t = lt_signed(Aw, Bw, f); break;
                                case OP_LE: t = !lt_signed(Bw, Aw, f); break;
                                case OP_GT: t = lt_signed(Bw, Aw, f); break;
                                default: t = !lt_signed(Aw, Bw, f); break;
                            }
                        }
                        res = t;
                        break;
                    }
                    default: err = 2; break;
                }
                r.v[0] = (u64)res;
                continue;
            }
            Fe ta, tb, tc;
            const Fe *Ap = &regs[prog->a[i]];
            const Fe *Bp = &regs[prog->b[i]];
            const Fe *Cp = &regs[prog->c[i]];
            if (prog->na[i]) { i64_to_fe(ta, (int64_t)Ap->v[0], f); Ap = &ta; }
            if (prog->nb[i]) { i64_to_fe(tb, (int64_t)Bp->v[0], f); Bp = &tb; }
            if (prog->nc[i]) { i64_to_fe(tc, (int64_t)Cp->v[0], f); Cp = &tc; }
            const Fe &A = *Ap;
            const Fe &B = *Bp;
            const Fe &C = *Cp;
            switch (prog->op[i]) {
                case OP_CONST: r = prog->consts[prog->imm[i]]; break;
                case OP_INPUT:
                    std::memcpy(r.v, in + prog->imm[i] * NL, 32);
                    break;
                case OP_ADD: add_mod(r, A, B, f); break;
                case OP_SUB: sub_mod(r, A, B, f); break;
                case OP_MUL: mont_mul(r, A, B, f); break;
                case OP_DIV: {
                    Fe binv;
                    inv_mont(binv, B, f);
                    mont_mul(r, A, binv, f);
                    break;
                }
                case OP_NEG: {
                    Fe z = {{0, 0, 0, 0}};
                    sub_mod(r, z, A, f);
                    break;
                }
                case OP_LT: set_bool(r, lt_signed(A, B, f)); break;
                case OP_LE: set_bool(r, !lt_signed(B, A, f)); break;
                case OP_GT: set_bool(r, lt_signed(B, A, f)); break;
                case OP_GE: set_bool(r, !lt_signed(A, B, f)); break;
                case OP_EQ:
                    set_bool(r, !std::memcmp(A.v, B.v, 32));
                    break;
                case OP_NEQ:
                    set_bool(r, std::memcmp(A.v, B.v, 32) != 0);
                    break;
                case OP_LAND: set_bool(r, !is_zero(A) && !is_zero(B)); break;
                case OP_LOR: set_bool(r, !is_zero(A) || !is_zero(B)); break;
                case OP_LNOT: set_bool(r, is_zero(A)); break;
                case OP_BAND:
                    for (int j = 0; j < NL; ++j) r.v[j] = A.v[j] & B.v[j];
                    break;
                case OP_BOR:
                    for (int j = 0; j < NL; ++j) r.v[j] = A.v[j] | B.v[j];
                    if (geq(r, f.p)) sub_raw(r, r, f.p);
                    break;
                case OP_BXOR:
                    for (int j = 0; j < NL; ++j) r.v[j] = A.v[j] ^ B.v[j];
                    if (geq(r, f.p)) sub_raw(r, r, f.p);
                    break;
                case OP_BNOT:
                    for (int j = 0; j < NL; ++j)
                        r.v[j] = (~A.v[j]) & f.mask.v[j];
                    if (geq(r, f.p)) sub_raw(r, r, f.p);
                    break;
                case OP_SHL_K: shl_k(r, A, (unsigned)prog->imm[i], f); break;
                case OP_SHR_K: shr_k(r, A, (unsigned)prog->imm[i]); break;
                case OP_POW_K: {
                    Fe e = {{(u64)prog->imm[i], 0, 0, 0}};
                    pow_mont(r, A, e, f);
                    break;
                }
                case OP_SELECT: r = is_zero(A) ? C : B; break;
                case OP_TO_MONT: mont_mul(r, A, f.r2, f); break;
                case OP_FROM_MONT: {
                    Fe one = {{1, 0, 0, 0}};
                    mont_mul(r, A, one, f);
                    break;
                }
                case OP_IDIV: {
                    if (is_zero(B)) { err = 1; r = B; break; }
                    Fe q, m;
                    divmod_raw(q, m, A, B);
                    r = q;
                    break;
                }
                case OP_MOD: {
                    if (is_zero(B)) { err = 1; r = B; break; }
                    Fe q, m;
                    divmod_raw(q, m, A, B);
                    r = m;
                    break;
                }
                case OP_MULP: {
                    // plain product of canonical values (narrow mul
                    // whose operands were widened): x*y mod p via
                    // Montgomery with an R^2 fixup
                    Fe t0;
                    mont_mul(t0, A, B, f);
                    mont_mul(r, t0, f.r2, f);
                    break;
                }
                default: err = 2; break;
            }
        }
        u64 *out = outputs + (size_t)w * prog->n_outputs * NL;
        for (int k = 0; k < prog->n_outputs; ++k) {
            int32_t src_reg = prog->outputs[k];
            if (prog->nres[src_reg]) {
                Fe t;
                i64_to_fe(t, (int64_t)regs[src_reg].v[0], f);
                std::memcpy(out + (size_t)k * NL, t.v, 32);
            } else {
                std::memcpy(out + (size_t)k * NL, regs[src_reg].v, 32);
            }
        }
    }
    }
    return err;
}

}  // extern "C"
