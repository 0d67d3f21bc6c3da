// K3's group build (comb.cu): COMB_BUILD_G neighbouring threads of one
// warp build one validator's A table in place (layout in comb.cuh).
//
// Per key: ZIP-215 decompression of the pubkey (an invalid key builds
// from the identity, so every Z stays nonzero), -A, the 64 positions x 8
// entries (e+1) 16^i (-A) in extended coordinates, and their canonical
// affine Niels words.
//
// The chain.  Position i starts at its base b = 16^i (-A) (entry 0) and
// reaches the next base 16 b by four doublings (2 b, 4 b, 8 b are
// entries 1, 3, 7); entries 2, 4, 6 are the cached adds 2 b + b, 4 b + b
// and 6 b + b, entry 5 the doubling of 3 b.  Each point operation is a
// group operation (ge25519_group.cuh): two phases of four independent
// multiplies, one a thread at G = 4, so a position costs 17 multiply
// latencies (the cached conversion of b, 5 doublings, 3 adds) where one
// thread spent 71.  The group runs its operations one after the other,
// so this order is no shorter than seven adds of b and one doubling,
// the first design's; it is cheaper, as a squaring shares its symmetric
// products, and measured 2-6% faster (PERF.md).  Each entry is parked in
// its own table slot as canonical X | Y | Z, every thread freezing and
// storing one coordinate.
//
// Normalisation runs data-parallel: thread t takes the entries k with
// k % G == t (its share, so the group's loads and stores of neighbouring
// entries are contiguous).  A forward pass over its share keeps the
// running product P of the share's Z's and rewrites each entry's slot as
// X P_k | Y P_k | Z, P_k the product before entry k; the G shares'
// totals meet by shuffles; one inversion of their product gives each
// thread its share's 1/P (Montgomery's trick); a backward pass reads
// X P_k, Y P_k and Z, so x = X P_k / P_{k+1}, y likewise, peels Z off the
// running inverse and writes (y+x, y-x, 2dxy).  The slots are the only
// scratch: no running product is stored per entry.
//
// Host build: as in ge25519_group.cuh, one call runs the whole group.
#pragma once

#include "comb.cuh"
#include "ge25519_group.cuh"

#define COMB_BUILD_G 4          // threads a key
#define COMB_BUILD_KEYS 8       // keys a block
#define COMB_BUILD_BLOCK (COMB_BUILD_KEYS * COMB_BUILD_G)
#define COMB_BUILD_MIN_BLOCKS 10  // __launch_bounds__: blocks an SM holds at once
#define COMB_NENT (COMB_NPOS_A * COMB_NENT_A)  // entries a key
static_assert(COMB_BUILD_G == 2 || COMB_BUILD_G == 4, "threads a key");

// 8 words at w (16-byte aligned: a slot is 96 bytes, a coordinate 32).
DEV void comb_store8(uint32_t* w, const uint32_t x[8]) {
#ifdef __CUDACC__
  uint4* q = (uint4*)w;
  q[0] = make_uint4(x[0], x[1], x[2], x[3]);
  q[1] = make_uint4(x[4], x[5], x[6], x[7]);
#else
  for (int i = 0; i < 8; i++) w[i] = x[i];
#endif
}

// Plain loads: the slots are written by this kernel, so not through the
// read-only cache.
DEV void comb_load8(uint32_t x[8], const uint32_t* w) {
#ifdef __CUDACC__
  const uint4* q = (const uint4*)w;
  const uint4 a = q[0], b = q[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
#else
  for (int i = 0; i < 8; i++) x[i] = w[i];
#endif
}

DEV void comb_load_fe(fe& h, const uint32_t* w) {
  uint32_t x[8];
  comb_load8(x, w);
  fe_from_words(h, x);
}

DEV void comb_store_fe(uint32_t* w, const fe& f) {
  uint32_t x[8];
  fe_to_words(x, f);
  comb_store8(w, x);
}

// Park p as X | Y | Z in a slot: coordinate c (< 3) by thread c % G.
template <int G>
DEV void comb_park(uint32_t* slot, const ge_p3& p, bool live, const grp_t& g) {
  GRP_EACH(G, l) {
    UNROLL
    for (int s = 0; s < (3 + G - 1) / G; s++) {
      const int c = s * G + GRP_TID(g, l);
      fe x;
      fe_sel4(x, c, p.X, p.Y, p.Z, p.Z);
      uint32_t w[8];
      fe_to_words(w, x);
      if (live && c < 3) comb_store8(slot + 8 * c, w);
    }
  }
}

// The key's table into tab (COMB_A_WORDS words); returns the key's
// ZIP-215 validity.  Every thread of the warp calls it (the shuffles need
// them all); a group past the batch's end (live false) stores nothing.
template <int G>
DEV bool comb_group_build(const uint8_t pub[32], uint32_t* tab, bool live, const grp_t& g) {
  ge_p3 a, id;
  const bool ok = ge_from_bytes_zip215(a, pub);
  ge_identity(id);
  fe_cmov(a.X, id.X, !ok);
  fe_cmov(a.Y, id.Y, !ok);
  fe_cmov(a.Z, id.Z, !ok);
  fe_cmov(a.T, id.T, !ok);
  ge_p3 b;
  ge_neg(b, a);
  NOUNROLL
  for (int i = 0; i < COMB_NPOS_A; i++) {
    uint32_t* pos = tab + i * COMB_NENT_A * COMB_ENTRY_WORDS;
    grp_slots<G> cb;
    grp_to_cached<G>(cb, b, g);
    ge_p3 p, t;  // entry e of the position is (e + 1) b
    comb_park<G>(pos, b, live, g);
    grp_dbl<G>(p, b, g);
    comb_park<G>(pos + 1 * COMB_ENTRY_WORDS, p, live, g);
    grp_add_cached<G>(t, p, cb, g);
    comb_park<G>(pos + 2 * COMB_ENTRY_WORDS, t, live, g);
    grp_dbl<G>(p, p, g);
    comb_park<G>(pos + 3 * COMB_ENTRY_WORDS, p, live, g);
    grp_dbl<G>(t, t, g);
    comb_park<G>(pos + 5 * COMB_ENTRY_WORDS, t, live, g);
    grp_add_cached<G>(t, t, cb, g);
    comb_park<G>(pos + 6 * COMB_ENTRY_WORDS, t, live, g);
    grp_add_cached<G>(t, p, cb, g);
    comb_park<G>(pos + 4 * COMB_ENTRY_WORDS, t, live, g);
    grp_dbl<G>(b, p, g);
    comb_park<G>(pos + 7 * COMB_ENTRY_WORDS, b, live, g);
    grp_dbl<G>(b, b, g);  // the next base, 16 b
  }
  GRP_SYNC();

  // forward: slot k = X P_k | Y P_k | Z over each thread's share
  fe run[GRP_GL(G)];
  GRP_EACH(G, l) {
    fe_1(run[l]);
    NOUNROLL
    for (int k = GRP_TID(g, l); k < COMB_NENT; k += G) {
      uint32_t* slot = tab + k * COMB_ENTRY_WORDS;
      fe X, Y, Z;
      comb_load_fe(X, slot);
      comb_load_fe(Y, slot + 8);
      comb_load_fe(Z, slot + 16);
      fe_mul(X, X, run[l]);
      fe_mul(Y, Y, run[l]);
      fe_mul(run[l], run[l], Z);
      if (live) {
        comb_store_fe(slot, X);
        comb_store_fe(slot + 8, Y);
      }
    }
  }
  // the shares' products meet: 1 / run[l] = oth[l] / (the product of all),
  // oth[l] the product of the other shares', from one inversion
  fe oth[GRP_GL(G)];
  GRP_EACH(G, l) fe_1(oth[l]);
  UNROLL
  for (int u = 0; u < G; u++) {
    fe q;
    fe_bcast<G>(q, run, u);
    GRP_EACH(G, l) {
      fe m;
      fe_1(m);
      fe_cmov(m, q, u != GRP_TID(g, l));
      fe_mul(oth[l], oth[l], m);
    }
  }
  fe all, inv_all, d2;
  fe_mul(all, oth[0], run[0]);  // the same product on every thread
  fe_invert(inv_all, all);
  fe_const_d2(d2);
  GRP_EACH(G, l) {
    fe inv;
    fe_mul(inv, inv_all, oth[l]);
    // backward over the share: inv = 1 / P_{k+1} on entering entry k
    NOUNROLL
    for (int k = COMB_NENT - G + GRP_TID(g, l); k >= 0; k -= G) {
      uint32_t* slot = tab + k * COMB_ENTRY_WORDS;
      fe X, Y, Z, x, y, t;
      comb_load_fe(X, slot);
      comb_load_fe(Y, slot + 8);
      comb_load_fe(Z, slot + 16);
      fe_mul(x, X, inv);
      fe_mul(y, Y, inv);
      fe_mul(inv, inv, Z);
      fe_mul(t, x, y);
      fe_mul(t, t, d2);
      if (live) {
        fe_add(X, y, x);
        comb_store_fe(slot, X);
        fe_sub(Y, y, x);
        comb_store_fe(slot + 8, Y);
        comb_store_fe(slot + 16, t);
      }
    }
  }
  return ok;
}

#ifndef __CUDACC__
// The host build of a launch: every key in turn, its group's threads in
// slots.
static void k3_host(const uint8_t* pubs, uint32_t* tables, uint8_t* valid, int V) {
  grp_t g;
  for (int v = 0; v < V; v++) {
    valid[v] = comb_group_build<COMB_BUILD_G>(pubs + (size_t)v * 32, tables + (size_t)v * COMB_A_WORDS, true, g)
                   ? 1
                   : 0;
  }
}
#endif
