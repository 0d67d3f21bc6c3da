// Edwards25519 point operations shared by a group of G neighbouring
// threads of one warp (K3's and K5's group forms; G = 2 or 4).
//
// Every formula of ge25519.cuh has two layers of independent multiplies:
//   doubling    X^2, Y^2, Z^2, (X+Y)^2        then  E F, G H, F G, E H
//   cached add  (Y1+X1) ypx2, (Y1-X1) ymx2,   then  E F, G H, F G, E H
//               (2 Z1) z2, T1 t2d2
// so a group runs each operation as two phases of four products.  Every
// thread of the group holds the whole point (the same values on every
// thread: each computes them from the same inputs), and in each phase
// computes only its own products: product j (0..3) belongs to thread
// j % G, in its slot j / G, and selects its operands by j, so the G
// threads run one instruction stream with no divergence.  After a phase
// the four products reach every thread of the group by __shfl_sync, as
// whole field elements (10 limbs each); the cheap sums (E, F, G, H) are
// then computed on every thread.  An operation thus takes the latency of
// two multiply phases instead of eight multiplies, and a phase costs 40
// shuffles against ~600 instructions of multiply.  No product is split
// and no multiply is added to the chain: a mixed add with an affine
// Niels entry is a cached add whose z2 is one (a multiply by one, where
// ge_madd doubles Z1 and carries), and a cached conversion's 2d T is
// computed by every thread.
//
// Cached operand: (ypx, ymx, z, t2d) = (Y+X, Y-X, Z, 2d T); product j of
// the add's first phase multiplies by its coordinate j, so a thread needs
// only the coordinates of its own slots (grp_slots), and a negated entry
// (swap ypx / ymx, negate t2d) is a choice of which coordinate a thread
// reads.  The products of the first phase come back as (B, A, D, C):
// E = B - A, F = D - C, G = D + C, H = B + A, as in ge_add.
//
// Limb contract (fe25519.cuh): the sums fed to a multiply are those of
// ge_dbl and ge_add (at most two TIGHT terms, carried where a third
// joins; D = (2 Z1) z2 is a multiply output, so F and G need no carry),
// every coordinate leaving an operation is a multiply output (TIGHT),
// and a cached entry's ypx / ymx are LOOSE, z and t2d TIGHT.  Values,
// not limbs, are what leave a kernel (verdicts, frozen table words), so
// representations may differ from the one-thread forms.
//
// Host build: outside nvcc a call holds all G threads of its group
// (GRP_GL(G) = G slots of per-thread values), loops over them where the
// card's threads run side by side, and the exchange reads the slots
// where the card shuffles, so g++ runs a group step for step.
#pragma once

#include "ge25519.cuh"

#ifdef __CUDACC__
#define GRP_GL(G) 1  // threads of its group a call holds: its own
struct grp_t {
  int t;  // the thread's index in its group
};
#define GRP_TID(g, l) ((g).t)
#define GRP_SYNC() __syncwarp()
#else
#define GRP_GL(G) (G)  // the host build holds the whole group
struct grp_t {};
#define GRP_TID(g, l) (l)
#define GRP_SYNC()
#endif
#define GRP_EACH(G, l) \
  UNROLL               \
  for (int l = 0; l < GRP_GL(G); l++)

// One value a product slot: thread l's slot s holds product s * G + tid.
template <int G>
struct grp_slots {
  fe v[GRP_GL(G)][4 / G];
};

// h = (a, b, c, d)[j], branch-free (j is the thread's own product index).
DEV void fe_sel4(fe& h, int j, const fe& a, const fe& b, const fe& c, const fe& d) {
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = j == 0 ? a.v[i] : j == 1 ? b.v[i] : j == 2 ? c.v[i] : d.v[i];
}

// Every product of a phase on every thread: q[j] from thread j % G's slot j / G.
template <int G>
DEV void grp_exchange(fe q[4], const grp_slots<G>& m) {
#ifdef __CUDACC__
  UNROLL
  for (int j = 0; j < 4; j++) {
    UNROLL
    for (int i = 0; i < 10; i++) q[j].v[i] = __shfl_sync(0xffffffffu, m.v[0][j / G].v[i], j % G, G);
  }
#else
  for (int j = 0; j < 4; j++) q[j] = m.v[j % G][j / G];
#endif
}

// h = thread `from`'s x (x holds one value a thread of the group).
template <int G>
DEV void fe_bcast(fe& h, const fe x[GRP_GL(G)], int from) {
#ifdef __CUDACC__
  UNROLL
  for (int i = 0; i < 10; i++) h.v[i] = __shfl_sync(0xffffffffu, x[0].v[i], from, G);
#else
  h = x[from];
#endif
}

template <int G>
DEV bool bool_bcast(const bool x[GRP_GL(G)], int from) {
#ifdef __CUDACC__
  return __shfl_sync(0xffffffffu, (int)x[0], from, G) != 0;
#else
  return x[from];
#endif
}

// The second phase, shared by every operation: (E F, G H, F G, E H).
template <int G>
DEV void grp_finish(ge_p3& r, const fe& e, const fe& f, const fe& g_, const fe& h, const grp_t& g) {
  grp_slots<G> m;
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      const int j = s * G + GRP_TID(g, l);
      fe a, b;
      fe_sel4(a, j, e, g_, f, e);
      fe_sel4(b, j, f, h, g_, h);
      fe_mul(m.v[l][s], a, b);
    }
  }
  fe q[4];
  grp_exchange<G>(q, m);
  fe_copy(r.X, q[0]);
  fe_copy(r.Y, q[1]);
  fe_copy(r.Z, q[2]);
  fe_copy(r.T, q[3]);
}

// r = 2p (ge_dbl's formula; r may alias p).
template <int G>
DEV void grp_dbl(ge_p3& r, const ge_p3& p, const grp_t& g) {
  grp_slots<G> m;
  fe xy;
  fe_add(xy, p.X, p.Y);
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      fe a;
      fe_sel4(a, s * G + GRP_TID(g, l), p.X, p.Y, p.Z, xy);
      fe_sq(m.v[l][s], a);
    }
  }
  fe q[4];  // X^2, Y^2, Z^2, (X+Y)^2
  grp_exchange<G>(q, m);
  fe e, f, g_, h;
  fe_add(h, q[0], q[1]);
  fe_sub(g_, q[1], q[0]);
  fe_sub(e, q[3], h);
  fe_carry(e);
  fe_add(f, q[2], q[2]);
  fe_sub(f, f, g_);
  fe_carry(f);
  grp_finish<G>(r, e, f, g_, h, g);
}

// r = p + c, c a cached operand given by each slot's coordinate
// (c.v[l][s] = coordinate s * G + tid of the entry); r may alias p.
template <int G>
DEV void grp_add_cached(ge_p3& r, const ge_p3& p, const grp_slots<G>& c, const grp_t& g) {
  grp_slots<G> m;
  fe ypx, ymx, zz;
  fe_add(ypx, p.Y, p.X);
  fe_sub(ymx, p.Y, p.X);
  fe_add(zz, p.Z, p.Z);
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      fe a;
      fe_sel4(a, s * G + GRP_TID(g, l), ypx, ymx, zz, p.T);
      fe_mul(m.v[l][s], a, c.v[l][s]);
    }
  }
  fe q[4];  // B, A, D, C
  grp_exchange<G>(q, m);
  fe e, f, g_, h;
  fe_sub(e, q[0], q[1]);
  fe_sub(f, q[2], q[3]);
  fe_add(g_, q[2], q[3]);
  fe_add(h, q[0], q[1]);
  grp_finish<G>(r, e, f, g_, h, g);
}

// Each slot's coordinate of p's cached form (Y+X, Y-X, Z, 2d T); every
// thread computes 2d T (one multiply, the latency of one either way).
template <int G>
DEV void grp_to_cached(grp_slots<G>& c, const ge_p3& p, const grp_t& g) {
  fe ypx, ymx, t2d, d2;
  fe_add(ypx, p.Y, p.X);
  fe_sub(ymx, p.Y, p.X);
  fe_const_d2(d2);
  fe_mul(t2d, p.T, d2);
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) fe_sel4(c.v[l][s], s * G + GRP_TID(g, l), ypx, ymx, p.Z, t2d);
  }
}
