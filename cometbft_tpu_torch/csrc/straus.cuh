// Lane body of K5 (uncached Straus verify), used by ed25519.cu: a group
// of G neighbouring threads of one warp checks one signature (G = 4 or
// 2, a template parameter; ed25519.cu picks it by batch size).
//
// One lane checks one signature against its own pubkey:
//   [8](s B + k (-A) - R) == identity, k = SHA-512(R || A || M) mod L,
// with A and R decoded under ZIP-215 and s < L.  The double-scalar
// product runs as one Straus chain over 64 radix-16 windows, most
// significant first: acc = 16 acc + k_i (-A) + s_i B.
//
// Windows: k in signed digits d_i in [-8, 7] against an 8-entry table
// of j (-A), j = 1..8 (a negative digit negates the entry, the zero
// digit adds the identity); s in unsigned 4-bit windows against the
// shared 16-entry table of j B, j = 0..15 (entry 0 is the identity).
// The signed digits are the nibbles of kb = k + 0x888...8 less 8 (the
// radix-16 form with digits in [-8, 7] is unique; see comb_verify.cuh),
// so any window's digit is read on its own.
//
// The group (ge25519_group.cuh): every point operation runs as two
// phases of four independent multiplies, one a thread at G = 4 (two at
// G = 2), so the chain of a window (4 doublings, a cached add, a
// B-window add) is 12 multiply phases instead of 47 multiplies.  A and R decompress at the same
// time, A on the group's even threads and R on its odd ones (the same
// code on an index-selected input); the one square-root chain of ~270
// multiplies is the lane's longest serial stretch.
//
// Shared memory a lane (StrausShared, lane-minor so that the threads of
// a warp read 32 banks): the -A table as cached entries (Y+X, Y-X, Z,
// 2dT), [entry][limb][lane][coordinate], of which each thread reads the
// coordinates of its own products (a negative digit reads Y-X for Y+X
// and negates 2dT); the decoded A and R, R kept for the last add; the
// digit words of kb and s, read by window.  Nothing sits in local
// memory.  The B window ([16 entries][3 coords][8 words] canonical affine
// Niels, 1.5 KB shared by all lanes) is read through the read-only
// cache, each thread its own coordinate; its z is one.
//
// Limb contract: see ge25519_group.cuh; a decoded point's coordinates
// are TIGHT, a table entry's Y+X / Y-X LOOSE and its Z and 2dT TIGHT.
//
// Host build: as in ge25519_group.cuh, one call runs the whole group;
// `j` is the lane's slot in its block's shared memory.
#pragma once

#include "ge25519_group.cuh"
#include "sc25519.cuh"

#define STRAUS_NWIN 64
#define STRAUS_NENT_A 8
#define STRAUS_ENTRY_WORDS 24
#define STRAUS_LANES 16       // lanes a block
#define STRAUS_G4_MAX_LANES 12288  // batches up to this run 4 threads a lane, larger ones 2 (ed25519.cu)
#define STRAUS_MIN_BLOCKS 6   // __launch_bounds__: blocks an SM holds at once

// A block's shared memory (26.6 KB at 16 lanes).
struct StrausShared {
  int32_t tab[STRAUS_NENT_A][10][STRAUS_LANES][4];  // j (-A), j = 1..8, cached
  int32_t pt[2][10][STRAUS_LANES][4];               // decoded A (0) and R (1): X, Y, Z, T
  uint32_t dig[16][STRAUS_LANES];                   // kb (words 0-7), s (8-15)
};

// Thread l's decoded point into pt[slot]: every thread writes the point
// it decoded (A on even threads, R on odd ones; equal values collide).
DEV void straus_put_point(StrausShared& sm, int slot, int j, const ge_p3& p) {
  UNROLL
  for (int i = 0; i < 10; i++) {
    sm.pt[slot][i][j][0] = p.X.v[i];
    sm.pt[slot][i][j][1] = p.Y.v[i];
    sm.pt[slot][i][j][2] = p.Z.v[i];
    sm.pt[slot][i][j][3] = p.T.v[i];
  }
}

DEV void straus_get_point(ge_p3& p, const StrausShared& sm, int slot, int j) {
  UNROLL
  for (int i = 0; i < 10; i++) {
    p.X.v[i] = sm.pt[slot][i][j][0];
    p.Y.v[i] = sm.pt[slot][i][j][1];
    p.Z.v[i] = sm.pt[slot][i][j][2];
    p.T.v[i] = sm.pt[slot][i][j][3];
  }
}

// Table entry e from each slot's coordinate.
template <int G>
DEV void straus_put_entry(StrausShared& sm, int e, int j, const grp_slots<G>& c, const grp_t& g) {
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      UNROLL
      for (int i = 0; i < 10; i++) sm.tab[e][i][j][s * G + GRP_TID(g, l)] = c.v[l][s].v[i];
    }
  }
}

// The table entry of signed digit d for each slot: coordinate jj of
// |d| (-A), negated for d < 0, the identity (1, 1, 1, 0) for d = 0.
template <int G>
DEV void straus_lookup(grp_slots<G>& c, const StrausShared& sm, int j, int d, const grp_t& g) {
  const bool neg = d < 0, zero = d == 0;
  const int e = zero ? 0 : (neg ? -d : d) - 1;
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      const int jj = s * G + GRP_TID(g, l);
      const int src = neg && jj < 2 ? 1 - jj : jj;
      fe x;
      UNROLL
      for (int i = 0; i < 10; i++) x.v[i] = sm.tab[e][i][j][src];
      fe nx;
      fe_neg(nx, x);
      fe_cmov(x, nx, neg && jj == 3);
      fe_1(c.v[l][s]);  // the zero digit's identity: 1, 1, 1, 0
      fe_0(nx);
      fe_cmov(c.v[l][s], nx, jj == 3);
      fe_cmov(c.v[l][s], x, !zero);
    }
  }
}

// The B-window entry of nibble w for each slot: coordinate jj of the
// affine Niels entry as a cached one, z = 1.
template <int G>
DEV void straus_b_entry(grp_slots<G>& c, const uint32_t* bwin, int w, const grp_t& g) {
  const uint32_t* e = bwin + w * STRAUS_ENTRY_WORDS;
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < 4 / G; s++) {
      const int jj = s * G + GRP_TID(g, l);
      uint32_t x[8];
      const int off = jj == 3 ? 16 : jj == 1 ? 8 : 0;
      UNROLL
      for (int i = 0; i < 8; i++) x[i] = LDG(e + off + i);
      fe_from_words(c.v[l][s], x);
      fe one;
      fe_1(one);
      fe_cmov(c.v[l][s], one, jj == 2);
    }
  }
}

// Lane j's verdict (block slot j), from its group's threads; every thread
// of the group returns it.  Every thread of the warp calls it (the
// shuffles need them all).
template <int G>
DEV bool straus_group_verify(const uint8_t a_enc[32], const uint8_t r_enc[32], const uint8_t s_enc[32],
                             const uint8_t digest[64], const uint32_t* bwin, StrausShared& sm, int j,
                             const grp_t& g) {
  static_assert(G == 2 || G == 4, "threads a lane: A and R decode on two of them");
  // k = digest mod L and s: each thread stores its share of the 16 words
  uint32_t x[16], k[8], kb[8], s[8];
  UNROLL
  for (int i = 0; i < 16; i++) {
    x[i] = (uint32_t)digest[4 * i] | ((uint32_t)digest[4 * i + 1] << 8) |
           ((uint32_t)digest[4 * i + 2] << 16) | ((uint32_t)digest[4 * i + 3] << 24);
  }
  sc_reduce512(k, x);
  uint64_t cy = 0;
  UNROLL
  for (int i = 0; i < 8; i++) {
    cy += (uint64_t)k[i] + 0x88888888u;
    kb[i] = (uint32_t)cy;
    cy >>= 32;
  }
  load_le256_bytes(s, s_enc);
  const bool s_ok = sc_lt_L(s);
  GRP_EACH(G, l) {
    UNROLL
    for (int w = 0; w < 16; w++) {
      if (w % G == GRP_TID(g, l)) sm.dig[w][j] = w < 8 ? kb[w] : s[w - 8];
    }
  }

  // A on even threads, R on odd ones, both parked in shared memory
  bool ok[GRP_GL(G)];
  GRP_EACH(G, l) {
    const int odd = GRP_TID(g, l) & 1;
    ge_p3 p;
    ok[l] = ge_from_bytes_zip215(p, odd ? r_enc : a_enc);
    straus_put_point(sm, odd, j, p);
  }
  const bool a_ok = bool_bcast<G>(ok, 0), r_ok = bool_bcast<G>(ok, 1);  // both shuffles on every thread
  const bool pre_ok = s_ok && a_ok && r_ok;
  GRP_SYNC();

  // the -A table: tab[e] = (e + 1) (-A) (1 doubling, 6 cached adds)
  ge_p3 na, acc;
  straus_get_point(na, sm, 0, j);
  ge_neg(na, na);
  grp_slots<G> c1, c;
  grp_to_cached<G>(c1, na, g);
  straus_put_entry<G>(sm, 0, j, c1, g);
  grp_dbl<G>(acc, na, g);
  grp_to_cached<G>(c, acc, g);
  straus_put_entry<G>(sm, 1, j, c, g);
  NOUNROLL
  for (int e = 2; e < STRAUS_NENT_A; e++) {
    grp_add_cached<G>(acc, acc, c1, g);
    grp_to_cached<G>(c, acc, g);
    straus_put_entry<G>(sm, e, j, c, g);
  }
  GRP_SYNC();

  ge_identity(acc);
  NOUNROLL
  for (int i = STRAUS_NWIN - 1; i >= 0; i--) {
    grp_dbl<G>(acc, acc, g);
    grp_dbl<G>(acc, acc, g);
    grp_dbl<G>(acc, acc, g);
    grp_dbl<G>(acc, acc, g);
    const int sh = 4 * (i & 7);
    const int d = (int)((sm.dig[i >> 3][j] >> sh) & 15u) - 8;
    straus_lookup<G>(c, sm, j, d, g);
    grp_add_cached<G>(acc, acc, c, g);
    straus_b_entry<G>(c, bwin, (int)((sm.dig[8 + (i >> 3)][j] >> sh) & 15u), g);
    grp_add_cached<G>(acc, acc, c, g);
  }
  ge_p3 nr;
  straus_get_point(nr, sm, 1, j);
  ge_neg(nr, nr);
  grp_to_cached<G>(c, nr, g);
  grp_add_cached<G>(acc, acc, c, g);
  grp_dbl<G>(acc, acc, g);
  grp_dbl<G>(acc, acc, g);
  grp_dbl<G>(acc, acc, g);
  return ge_is_identity(acc) && pre_ok;
}

#ifndef __CUDACC__
// The host build of a launch at group width G: every lane in turn, its
// group's threads in slots, block slot j = lane % STRAUS_LANES.
template <int G>
static void k5_host(const uint8_t* a_enc, const uint8_t* r_enc, const uint8_t* s_enc, const uint8_t* digest,
                    const uint32_t* bwin, uint8_t* out, int n) {
  static StrausShared sm;
  grp_t g;
  for (int v = 0; v < n; v++) {
    const size_t o = (size_t)v * 32;
    out[v] = straus_group_verify<G>(a_enc + o, r_enc + o, s_enc + o, digest + (size_t)v * 64, bwin, sm,
                                    v % STRAUS_LANES, g)
                 ? 1
                 : 0;
  }
}
#endif
