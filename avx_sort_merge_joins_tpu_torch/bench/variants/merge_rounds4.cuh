// The radix-4 tile merge of K2's keys, a design that was measured and not
// taken: kernel_variants' k2_rounds4 inserts this file into a copy of
// csrc/merge_path.cuh (before merge_tile, inside namespace smj_mp) and
// sends K2's keys through merge_rounds4.  Each round merges four runs with
// the four heads in registers (a two-level tournament, two compares and
// one reload an output), so a W = 16 tile passes through shared memory
// twice, not four times; but each thread first splits its first output
// among the four runs (quad_split), which costs several pairwise co-rank
// searches, and the kernel is bound by instruction issue, not by shared
// memory: on an H100 a 128M-key W = 16 level took 2.83 ms against 1.08 for
// the pairwise rounds.

// x[i] of four registers, i in [0, 4): selects, not an indexed array,
// which would go to local memory.
template <typename T>
__device__ __forceinline__ T pick4(int i, const T (&x)[4]) {
  return i < 2 ? (i == 0 ? x[0] : x[1]) : (i == 2 ? x[2] : x[3]);
}

// First i in [lo, hi) of the run at slot `base` of buf whose element is not
// before y: above y, or equal to it and the run not below y's (`upper`:
// the run lies below y's, so its elements == y come first).  From the
// guess g it widens a bracket by doubling steps, then halves it.
template <typename E>
__device__ __forceinline__ int gallop(const E* buf, int base, int lo, int hi,
                                      int g, E y, bool upper) {
  if (lo >= hi) return lo;
  g = g < lo ? lo : (g >= hi ? hi - 1 : g);
  const auto before = [&](int i) {
    const E u = buf[sw<E>(base + i)];
    return u < y || (upper && u == y);
  };
  const bool up = before(g);
  int a = up ? g + 1 : lo, z = up ? hi : g;  // the answer is in [a, z]
  for (int step = 1;; step <<= 1) {
    const int i = up ? g + step : g - step;
    if (i < a || i >= z) break;
    const bool b = before(i);
    if (b) a = i + 1; else z = i;
    if (b != up) break;
  }
  while (a < z) {
    const int mid = (a + z) >> 1;
    if (before(mid)) a = mid + 1; else z = mid;
  }
  return a;
}

// One thread: c[r] = run r's share of the first d outputs of the merge of
// four ascending runs (run r at slots [b[r], b[r] + n[r]) of buf; ties go
// to the lower run).  The runs' windows [lo_r, hi_r) narrow around the
// split, from the bounds the run lengths give: every element before a
// window is among the first d outputs, none from its end on.  Each round
// takes the element y of the widest window at the share of the window the
// remaining outputs take, finds y's place in every other window by a
// gallop from the same share, and so y's rank among the windows' elements:
// below the outputs still to place, y and everything before it join the
// prefix (the starts move up), else y and everything after it leave it
// (the ends move down).  The pivot's window shrinks every round; on sorted
// random runs 3 to 6 rounds end it.
template <typename E>
__device__ __forceinline__ void quad_split(const E* buf, const int (&b)[4],
                                           const int (&n)[4], int d,
                                           int (&c)[4]) {
  const int total = n[0] + n[1] + n[2] + n[3];
  int lo[4], hi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int o = d - (total - n[r]);
    lo[r] = o > 0 ? o : 0;
    hi[r] = n[r] < d ? n[r] : d;
  }
  for (;;) {
    int sl = 0, sh = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sl += lo[r];
      sh += hi[r];
    }
    if (sl == d || sh == d) {
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = sl == d ? lo[r] : hi[r];
      return;
    }
    // the pivot run ps: the widest window, the lowest run among equals
    int ps = 0, pw = hi[0] - lo[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
      const int w = hi[r] - lo[r];
      if (w > pw) {
        pw = w;
        ps = r;
      }
    }
    const int rem = d - sl;
    const float f = (float)rem / (float)(sh - sl);  // in (0, 1)
    int off = (int)(f * (float)pw);
    off = off < pw ? off : pw - 1;
    const int m = pick4(ps, lo) + off;
    const E y = buf[sw<E>(pick4(ps, b) + m)];
    int cnt[4];
    int rank = 0;  // y's rank among the windows' elements
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool piv = r == ps;  // its window [m, m): the gallop gives m
      const int a = piv ? m : lo[r], z = piv ? m : hi[r];
      cnt[r] = gallop(buf, b[r], a, z, lo[r] + (int)(f * (float)(z - a)), y,
                      r < ps);
      rank += cnt[r] - lo[r];
    }
    if (rank < rem) {  // y is among the first d outputs
#pragma unroll
      for (int r = 0; r < 4; ++r) lo[r] = r == ps ? m + 1 : cnt[r];
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) hi[r] = r == ps ? m : cnt[r];
    }
  }
}

// The whole CTA of kThreads threads (all of them call it), as merge_rounds,
// in radix-4 rounds: each merges every four adjacent s-segment runs
// (quads) of `from` into `to`, s = 1, 4, 16, ... while 4 s <= W, and an
// odd log2(W) ends with one pairwise round; W = 2 is merge_rounds_select.  A
// thread finds the quad that holds its first output p0 and the exact split
// of p0 among the quad's runs (quad_split), then merges its kTileN /
// kThreads outputs serially with the four heads in registers: a
// two-level tournament, two compares and one reload an output.
template <typename E, int kThreads, int kTileN = kTile>
__device__ const E* merge_rounds4(const int* offs, int W, E* buf0, E* buf1) {
  if (W == 2)
    return merge_rounds_select<E, kThreads, kTileN>(offs, W, buf0, buf1);
  constexpr int kPerThread = kTileN / kThreads;
  const E inf = elem_inf<E>();
  const int n = offs[W];
  E* from = buf0;
  E* to = buf1;
  const int p0 = threadIdx.x * kPerThread;
  int s = 1;
  for (; 4 * s <= W; s <<= 2) {
    if (p0 < n) {
      const int g = 4 * s;  // segments a quad
      // the quad j holding output p0: the first whose end is past it
      int j = 0, jhi = W / g - 1;
      while (j < jhi) {
        const int mid = (j + jhi) >> 1;
        if (offs[(mid + 1) * g] > p0) jhi = mid; else j = mid + 1;
      }
      int pos[4], end[4];  // each run's head slot and end
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pos[r] = offs[j * g + r * s];
        end[r] = offs[j * g + (r + 1) * s];
      }
      int qe = end[3];  // the quad's end
      {
        int len[4], c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) len[r] = end[r] - pos[r];
        quad_split(from, pos, len, p0 - pos[0], c);
#pragma unroll
        for (int r = 0; r < 4; ++r) pos[r] += c[r];
      }
      E v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = pos[r] < end[r] ? from[sw<E>(pos[r])] : inf;
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int p = p0 + q;
        if (p < n) {
          while (p >= qe) {  // into the next quad
            ++j;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              pos[r] = offs[j * g + r * s];
              end[r] = offs[j * g + (r + 1) * s];
              v[r] = pos[r] < end[r] ? from[sw<E>(pos[r])] : inf;
            }
            qe = end[3];
          }
          // each pair's head (the lower run wins ties), then the smaller
          const bool lb = v[1] < v[0], rd = v[3] < v[2];
          const E vl = lb ? v[1] : v[0], vr = rd ? v[3] : v[2];
          const bool right = vr < vl;
          to[sw<E>(p)] = right ? vr : vl;
          const int w = right ? 2 + rd : lb;  // the run that gave it
          const int np = pick4(w, pos) + 1;
          const E nv = np < pick4(w, end) ? from[sw<E>(np)] : inf;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (r == w) {
              pos[r] = np;
              v[r] = nv;
            }
          }
        }
      }
    }
    __syncthreads();
    E* x = from;
    from = to;
    to = x;
  }
  if (s < W) {  // W / s == 2: the last round is pairwise
    merge_pairs_select<E, kThreads, kTileN>(offs, W, s, from, to);
    __syncthreads();
    from = to;
  }
  return from;
}
