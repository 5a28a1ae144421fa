// K4 bubble_bfs: the per-source bounded Kahn BFS of bubble popping (port of
// miniasm_tpu/graph/devbub.py:_bub_kernel, the vmap of while_loops; the
// reference is asg_bub_pop1, asg.c:360-405).
//
// One warp per candidate source.  Each source follows the serial
// asg_bub_pop1 order exactly, as devbub.py:_host_pop1 does: pop the stack
// top, sweep its arc row in slot order;
//   - an arc back to v0 aborts even when the arc is deleted (asg.c:379);
//   - a live arc whose distance d+l (wrapping, wadd) exceeds max_dist
//     aborts;
//   - a first visit sets parent, distance and the in-edge count but NOT c
//     (c stays 0 until a second in-edge relaxes it, asg.c:383-389);
//   - a revisit takes the parent on c+1 > c_w, or c+1 == c_w and
//     d+l > d_w, against the running values;
//   - a vertex whose in-edges are all seen is pushed, or counted as a tip
//     when its row has no slots at all (asg.c:393-396);
//   - the visited set overflows exactly when it holds K vertices and a new
//     one arrives (the wrapper then runs that source again at 2K);
//   - success: one vertex on the stack (the sink) and nothing pending.
// On aborted sources the JAX program visits a superset (it processes whole
// rows); results on successful sources are identical.
//
// What bounds it on the card, and what the design does about each:
//   - Latency, not bytes: a source pops its rows one after another, and
//     each row is a chain of dependent loads and warp votes.  A launch
//     lasts as long as its longest source (64-86 rows on the E. coli noisy
//     graphs), whatever the number of sources; thousands of sources run at
//     once, one warp each, up to 8 a block, so their chains overlap.
//   - The source's state (row starts and lengths, visited set, parents,
//     distances, counters, in-edge counts: K words each, the stack K+1)
//     sits in the warp's slice of dynamic shared memory, 2.3 KB at K = 64.
//     Where even one warp's slice does not fit a block (or the caller caps
//     the block's shared memory), the same code points the slice at
//     global scratch, one contiguous slice per source, so that the warp's
//     32-wide reads of it coalesce; only the base pointer differs.
//   - A popped vertex's row start and length come from its slot (stored at
//     its first visit), so a row costs two rounds of global loads: the
//     lanes load 32 arcs at a time, coalesced, and each lane at once loads
//     its target's row bounds (first[w], first[w+1]) and in-degree
//     (live_out[w^1]), whether or not an earlier arc aborts; that second
//     round overlaps the votes and the visited lookup.  One ballot finds
//     the first aborting arc of the chunk.
//   - The visited lookup of the chunk's targets reads the shared visited
//     set 32 entries per step and takes each target's match by ballot and
//     ffs: nb/32 shared reads instead of nb dependent global loads.
//   - The serial bookkeeping becomes warp-wide: new vertices take their
//     slots by ballot and popc in arc order (the one that finds the set
//     full overflows, and stops the arcs after it), each lane updates its
//     own target's slot, and pushes and tips count by ballot.  Arcs to one
//     target (multi-arcs) revisit in rounds, one arc of each target a
//     round, so the running c and d are those of the serial order.
//   - The warp writes vis and par (-1 past nb) and the four result rows.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;  // sources per block

// int32 words of one source's state: row starts (int64, 2K words), vis,
// par, d, c, r, row lengths (K each), the stack (K + 1); even, so that
// every slice starts 8-byte aligned
inline __host__ __device__ int64_t state_words(int K) {
    return (9 * static_cast<int64_t>(K) + 2) & ~static_cast<int64_t>(1);
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
bubble_bfs_kernel(const int64_t* __restrict__ first,
                  const int32_t* __restrict__ av,
                  const int32_t* __restrict__ al,
                  const uint8_t* __restrict__ adel,
                  const int32_t* __restrict__ live_out,
                  const int32_t* __restrict__ sources, int64_t S, int K,
                  int32_t max_dist, int32_t* __restrict__ res,
                  int32_t* __restrict__ vis_out,
                  int32_t* __restrict__ par_out, int32_t* work) {
    extern __shared__ int64_t smem[];
    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const int64_t s = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      wib;
    if (s >= S) return;  // the whole warp
    const int64_t W = state_words(K);
    int32_t* base = work ? work + s * W
                         : reinterpret_cast<int32_t*>(smem) + wib * W;
    int64_t* rs = reinterpret_cast<int64_t*>(base);  // row start of slot k
    int32_t* vis = base + 2 * static_cast<int64_t>(K);
    int32_t* par = vis + K;
    int32_t* d = par + K;
    int32_t* c = d + K;
    int32_t* r = c + K;
    int32_t* rn = r + K;    // row length of slot k
    int32_t* stk = rn + K;  // K + 1 slots

    const int32_t v0 = sources[s];
    if (lane == 0) {
        const int64_t f0 = first[v0];
        vis[0] = v0;
        par[0] = -1;
        d[0] = 0;
        c[0] = 0;
        rs[0] = f0;
        rn[0] = static_cast<int32_t>(first[v0 + 1] - f0);
        stk[0] = 0;
    }
    __syncwarp();
    const unsigned lt = (1u << lane) - 1;  // the lanes before this one
    // warp-uniform state: every lane holds the same values
    int sp = 1, nb = 1, npend = 0, ntip = 0;
    bool ok = false, ovf = false;
    int32_t sink = -1;
    while (true) {
        const int vs = stk[--sp];  // the popped vertex's slot
        const int32_t v = vis[vs], dv = d[vs], cv = c[vs];
        const int64_t a0 = rs[vs];
        const int na = rn[vs];
        bool fail = false;
        for (int cb = 0; cb < na && !fail; cb += 32) {
            const int n_here = min(32, na - cb);
            int32_t w = 0, dd = 0, lo = 0;
            int64_t f = 0, fe = 0;
            bool del = true, bad = false;
            if (lane < n_here) {
                const int64_t ai = a0 + cb + lane;
                w = av[ai];
                del = adel[ai] != 0;
                dd = wadd(dv, al[ai]);
                bad = w == v0 || (!del && dd > max_dist);
                if (!del) {  // the second round of loads, issued early
                    f = first[w];
                    fe = first[w + 1];
                    lo = live_out[w ^ 1];
                }
            }
            // the arcs before the chunk's first aborting arc are processed
            const unsigned bm = __ballot_sync(FULL, bad);
            const int n_ok = bm ? __ffs(bm) - 1 : n_here;
            // the live arcs before it; arcs to one target form a group
            // whose first arc leads (the rest revisit the leader's slot)
            const bool act = lane < n_ok && !del;
            const unsigned same = __match_any_sync(FULL, act ? w : -2 - lane);
            const int grank = __popc(same & lt);
            const unsigned lead = __ballot_sync(FULL, act && grank == 0);
            // visited lookup of each leader's target: the shared visited
            // set 32 entries at a time, one ballot per leader
            int ws = -1;
            unsigned todo = lead;
            for (int kb = 0; kb < nb && todo; kb += 32) {
                const int32_t vk = kb + lane < nb ? vis[kb + lane] : -1;
                for (unsigned t = todo; t; t &= t - 1) {
                    const int j = __ffs(t) - 1;
                    const unsigned m =
                        __ballot_sync(FULL, vk == __shfl_sync(FULL, w, j));
                    if (lane == j && m) ws = kb + __ffs(m) - 1;
                }
                todo &= ~__ballot_sync(FULL, ws >= 0);
            }
            // new vertices take slots nb, nb+1, ... in arc order; the one
            // that finds the set full overflows, and the arcs from it on
            // are not processed
            const bool fresh = (lead >> lane & 1) && ws < 0;
            const unsigned fm = __ballot_sync(FULL, fresh);
            int cut = n_ok;
            if (__popc(fm) > K - nb) {
                const unsigned ov = __ballot_sync(
                    FULL, fresh && __popc(fm & lt) == K - nb);
                cut = __ffs(ov) - 1;
                ovf = true;
                fail = true;
            }
            const bool go = act && lane < cut;
            const int at = __shfl_sync(
                FULL, fresh ? nb + __popc(fm & lt) : ws, __ffs(same) - 1);
            const int fn = static_cast<int>(fe - f);
            // the bookkeeping, in rounds: a group's k-th arc in round k,
            // so each round touches distinct slots
            const int top = __reduce_max_sync(FULL, go ? grank : 0);
            int32_t rw = -1;
            for (int rd = 0; rd <= top; ++rd) {
                if (go && grank == rd) {
                    if (fresh) {
                        vis[at] = w;
                        par[at] = v;
                        d[at] = dd;
                        c[at] = 0;
                        rs[at] = f;
                        rn[at] = fn;
                        rw = lo - 1;
                    } else {
                        const int32_t cw = c[at], dw = d[at];
                        if (cv + 1 > cw || (cv + 1 == cw && dd > dw))
                            par[at] = v;
                        if (cv + 1 > cw) c[at] = cv + 1;
                        if (dd < dw) d[at] = dd;
                        rw = r[at] - 1;
                    }
                    r[at] = rw;
                }
                __syncwarp();
            }
            // a vertex whose in-arcs are all seen is pushed (in arc order)
            // or counted as a tip
            const bool ready = go && rw == 0;
            const unsigned pm = __ballot_sync(FULL, ready && fn > 0);
            const unsigned tm = __ballot_sync(FULL, ready && fn == 0);
            if (pm >> lane & 1) stk[sp + __popc(pm & lt)] = at;
            const int n_new = __popc(__ballot_sync(FULL, fresh && go));
            nb += n_new;
            npend += n_new - __popc(pm | tm);
            sp += __popc(pm);
            ntip += __popc(tm);
            __syncwarp();
            if (bm) fail = true;
        }
        if (fail || sp == 0) break;
        if (sp == 1 && npend == 0) {
            ok = true;
            sink = vis[stk[0]];
            break;
        }
    }
    __syncwarp();
    int32_t* vo = vis_out + s * K;
    int32_t* po = par_out + s * K;
    for (int k = lane; k < K; k += 32) {
        vo[k] = k < nb ? vis[k] : -1;
        po[k] = k < nb ? par[k] : -1;
    }
    if (lane == 0) {
        res[s] = (ok ? 1 : 0) | (ovf ? 2 : 0);
        res[S + s] = nb;
        res[2 * S + s] = ntip;
        res[3 * S + s] = sink;
    }
}

}  // namespace

// work: global scratch of S * state_words(K) int32, or null to keep the
// state in shared memory, at most max_smem bytes a block
extern "C" int ma_bubble_bfs(const int64_t* first, const int32_t* av,
                             const int32_t* al, const uint8_t* adel,
                             const int32_t* live_out, const int32_t* sources,
                             int64_t S, int K, int max_dist, int32_t* res,
                             int32_t* vis, int32_t* par, int32_t* work,
                             int max_smem, cudaStream_t stream) {
    const int64_t per_warp = state_words(K) * 4;
    int warps = MAX_WARPS;
    size_t smem = 0;
    if (work == nullptr) {
        warps = static_cast<int>(
            std::min<int64_t>(MAX_WARPS, max_smem / per_warp));
        if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
        smem = static_cast<size_t>(warps * per_warp);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                bubble_bfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
    }
    bubble_bfs_kernel<<<n_blocks(S, warps), warps * 32, smem, stream>>>(
        first, av, al, adel, live_out, sources, S, K, max_dist, res, vis,
        par, work);
    return static_cast<int>(cudaGetLastError());
}
