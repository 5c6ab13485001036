/* The witness-replay VM: host C, no CUDA.
 *
 * Witness generation runs the circuit's generators (reference
 * plonky2/src/iop/generator.rs:25-106) over field elements.  Which
 * generator runs when depends only on which targets the caller presets,
 * not on their values, so the port records one fixpoint run's completion
 * order per circuit and set of preset targets, lowers each generator to
 * the instructions below (native/lower.py) and replays that stream for
 * every later witness (native/schedule.py).  A port of the JAX package's
 * native/witgen.c, instruction for instruction.
 *
 * The VM works on one flat u64 value array: the witness's representative
 * slots first (indices below num_reps), then the stream's temporaries.
 * A store into a representative slot checks against the filled bitmap:
 * it sets an empty slot, and it fails on a filled slot that holds another
 * value, as PartitionWitness.set_target_returning_rep does
 * (iop/witness.py; reference witness.rs:321-385).  Temporaries are written
 * without a check.
 *
 * An instruction is 5 u64 words: op, dst, a, b, c.  The operands index the
 * value array unless the comment below calls them imm.  A failure returns
 * (code << 48) | instruction index; success returns 0.
 *
 * Build: cc -O2 -shared -fPIC (ops/_build.py build_host).
 */

#include <stddef.h>
#include <stdint.h>

typedef uint64_t u64;
typedef uint32_t u32;
typedef unsigned __int128 u128;

enum {
    OP_CONST = 0,   /* dst = imm a */
    OP_COPY = 1,    /* dst = v[a] */
    OP_ADD = 2,     /* dst = v[a] + v[b] */
    OP_SUB = 3,     /* dst = v[a] - v[b] */
    OP_MUL = 4,     /* dst = v[a] * v[b] */
    OP_MULC = 5,    /* dst = v[a] * imm b */
    OP_ADDC = 6,    /* dst = v[a] + imm b */
    OP_RSUBC = 7,   /* dst = imm b - v[a] */
    OP_MAC = 8,     /* dst = v[a] * v[b] + v[c] */
    OP_MACI = 9,    /* dst = v[a] * imm c + v[b] */
    OP_INV = 10,    /* dst = 1 / v[a]; fails on zero */
    OP_POW7 = 11,   /* dst = v[a]^7 */
    OP_SELECT = 12, /* dst = v[pool[b + v[a]]]; fails unless v[a] < imm c */
    OP_BIT = 13,    /* dst = bit imm b of v[a] */
    OP_SPLITR = 14, /* the dst digits of v[a] in base imm c, least
                       significant first, stored to pool[b], pool[b + 1],
                       ...; fails if a remainder is left */
    OP_SHRM = 15,   /* dst = (v[a] >> imm b) & imm c */
    OP_ASHR0 = 16,  /* fails unless v[a] >> imm b is 0 */
    OP_ABOOL = 17,  /* fails unless v[a] is 0 or 1 */
    OP_LUTMAP = 18, /* dst = pool[b + 1 + v[a]]; fails unless
                       v[a] < pool[b] (a table indexed by its input) */
};

enum {
    ERR_CONTRADICTION = 1,
    ERR_INV_ZERO = 2,
    ERR_SELECT_OOB = 3,
    ERR_SPLIT_LEFTOVER = 4,
    ERR_SHR_NONZERO = 5,
    ERR_BAD_OPCODE = 6,
    ERR_NOT_BOOL = 7,
    ERR_LUT_MISS = 8,
};

#define GL_P 0xFFFFFFFF00000001ULL

/* a, b < p: the sum may pass 2^64 for Goldilocks */
static inline u64 add_mod(u64 a, u64 b, u64 p) {
    u64 s = a + b;
    if (s < a || s >= p) s -= p;
    return s;
}

static inline u64 sub_mod(u64 a, u64 b, u64 p) {
    return a >= b ? a - b : a + p - b;
}

/* x mod the Goldilocks prime, from 2^64 = 2^32 - 1 and 2^96 = -1 */
static inline u64 gl_reduce128(u128 x) {
    u64 lo = (u64)x;
    u64 hi = (u64)(x >> 64);
    u64 hi_lo = (u32)hi;
    u64 hi_hi = hi >> 32;
    u64 t = lo - hi_hi;           /* lo - hi_hi * 2^96 */
    if (lo < hi_hi) t -= 0xFFFFFFFFull;   /* a borrow: 2^64 too much */
    u64 m = (hi_lo << 32) - hi_lo;        /* hi_lo * 2^64 */
    u64 r = t + m;
    if (r < t) r += 0xFFFFFFFFull;        /* a carry: 2^64 too little */
    if (r >= GL_P) r -= GL_P;
    return r;
}

static inline u64 mul_mod(u64 a, u64 b, u64 p) {
    u128 x = (u128)a * b;
    if (p == GL_P) return gl_reduce128(x);
    return (u64)(x % p);
}

static inline u64 pow_mod(u64 a, u64 e, u64 p) {
    u64 r = 1;
    for (; e; e >>= 1) {
        if (e & 1) r = mul_mod(r, a, p);
        a = mul_mod(a, a, p);
    }
    return r;
}

/* 1 / a by Fermat: p is prime, and an inverse is rare in a stream */
static inline u64 inv_mod(u64 a, u64 p) { return pow_mod(a, p - 2, p); }

/* the checked store: returns 1 on a contradiction */
static inline int store(u64 dst, u64 val, u64 *v, uint8_t *filled,
                        u64 num_reps) {
    if (dst >= num_reps) {
        v[dst] = val;
        return 0;
    }
    if (filled[dst]) return v[dst] != val;
    filled[dst] = 1;
    v[dst] = val;
    return 0;
}

#define FAIL(code) return ((u64)(code) << 48) | i

u64 witgen_run(u64 p, const u64 *code, u64 n_instr, const u64 *pool,
               u64 *v, uint8_t *filled, u64 num_reps) {
    for (u64 i = 0; i < n_instr; i++) {
        const u64 *w = code + 5 * i;
        u64 op = w[0], dst = w[1], a = w[2], b = w[3], c = w[4];
        u64 r;
        switch (op) {
        case OP_CONST: r = a; break;
        case OP_COPY: r = v[a]; break;
        case OP_ADD: r = add_mod(v[a], v[b], p); break;
        case OP_SUB: r = sub_mod(v[a], v[b], p); break;
        case OP_MUL: r = mul_mod(v[a], v[b], p); break;
        case OP_MULC: r = mul_mod(v[a], b, p); break;
        case OP_ADDC: r = add_mod(v[a], b, p); break;
        case OP_RSUBC: r = sub_mod(b, v[a], p); break;
        case OP_MAC: r = add_mod(mul_mod(v[a], v[b], p), v[c], p); break;
        case OP_MACI: r = add_mod(mul_mod(v[a], c, p), v[b], p); break;
        case OP_INV:
            if (v[a] == 0) FAIL(ERR_INV_ZERO);
            r = inv_mod(v[a], p);
            break;
        case OP_POW7: {
            /* x^7 by x^2, x^3, x^6: the algebra's exp7 */
            u64 x = v[a];
            u64 x2 = mul_mod(x, x, p);
            u64 x3 = mul_mod(x2, x, p);
            u64 x6 = mul_mod(x3, x3, p);
            r = mul_mod(x6, x, p);
            break;
        }
        case OP_SELECT:
            if (v[a] >= c) FAIL(ERR_SELECT_OOB);
            r = v[pool[b + v[a]]];
            break;
        case OP_BIT: r = b >= 64 ? 0 : (v[a] >> b) & 1; break;
        case OP_SPLITR: {
            u64 x = v[a];
            for (u64 k = 0; k < dst; k++) {
                if (store(pool[b + k], x % c, v, filled, num_reps))
                    FAIL(ERR_CONTRADICTION);
                x /= c;
            }
            if (x != 0) FAIL(ERR_SPLIT_LEFTOVER);
            continue;
        }
        case OP_SHRM: r = b >= 64 ? 0 : (v[a] >> b) & c; break;
        case OP_ASHR0:
            if (b < 64 && (v[a] >> b) != 0) FAIL(ERR_SHR_NONZERO);
            continue;
        case OP_ABOOL:
            if (v[a] > 1) FAIL(ERR_NOT_BOOL);
            continue;
        case OP_LUTMAP:
            if (v[a] >= pool[b]) FAIL(ERR_LUT_MISS);
            r = pool[b + 1 + v[a]];
            break;
        default:
            FAIL(ERR_BAD_OPCODE);
        }
        if (store(dst, r, v, filled, num_reps)) FAIL(ERR_CONTRADICTION);
    }
    return 0;
}

/* The dense witness: out[k] = v[rep[k]] where that slot is filled, else
 * 0 (PartitionWitness.full_witness). */
void witgen_gather(const u64 *v, const uint8_t *filled, const int64_t *rep,
                   u64 n, u64 *out) {
    for (u64 k = 0; k < n; k++) {
        int64_t s = rep[k];
        out[k] = filled[s] ? v[s] : 0;
    }
}
