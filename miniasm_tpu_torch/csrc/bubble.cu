// K4 bubble_bfs: the per-source bounded Kahn BFS of bubble popping (port of
// miniasm_tpu/graph/devbub.py:_bub_kernel, the vmap of while_loops; the
// reference is asg_bub_pop1, asg.c:360-405).
//
// One thread per candidate source, with the source's visited set, parents,
// distances, in-edge counters and stack (capacity K) in global scratch.  It
// follows the serial asg_bub_pop1 order exactly, as devbub.py:_host_pop1
// does: pop a vertex, sweep its arc row in slot order;
//   - an arc back to v0 aborts even when the arc is deleted (asg.c:379);
//   - a live arc whose distance d+l exceeds max_dist aborts;
//   - a first visit sets parent, distance and the in-edge count but NOT c
//     (c stays 0 until a second in-edge relaxes it, asg.c:383-389);
//   - a revisit takes the parent on c+1 > c_w, or c+1 == c_w and
//     d+l > d_w, against the running values;
//   - a vertex whose in-edges are all seen is pushed, or counted as a tip
//     when its row has no slots at all (asg.c:393-396);
//   - success: one vertex on the stack (the sink) and nothing pending.
// A visited set that outgrows K sets the overflow flag; the wrapper then
// doubles K and runs again.  On aborted sources the JAX program visits a
// superset (it processes whole rows); results on successful sources are
// identical.
//
// Bound on the card: each source touches a few dozen arc rows (bounded by
// max_dist); the visited-set lookup is a linear scan of at most K entries,
// so a source costs O(arcs * K) dependent loads: latency bound, a few
// microseconds for thousands of sources in parallel.
#include "common.cuh"

namespace {

__global__ void bubble_bfs_kernel(const int64_t* __restrict__ first,
                                  const int32_t* __restrict__ av,
                                  const int32_t* __restrict__ al,
                                  const uint8_t* __restrict__ adel,
                                  const int32_t* __restrict__ live_out,
                                  const int32_t* __restrict__ sources,
                                  int64_t S, int K, int32_t max_dist,
                                  int32_t* __restrict__ res,
                                  int32_t* __restrict__ vis_all,
                                  int32_t* __restrict__ par_all,
                                  int32_t* __restrict__ work) {
    const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (s >= S) return;
    int32_t* vis = vis_all + s * K;
    int32_t* par = par_all + s * K;
    int32_t* d = work + s * (4 * static_cast<int64_t>(K) + 1);
    int32_t* c = d + K;
    int32_t* r = c + K;
    int32_t* stk = r + K;  // K + 1 slots
    for (int k = 0; k < K; ++k) {
        vis[k] = -1;
        par[k] = -1;
    }
    const int32_t v0 = sources[s];
    vis[0] = v0;
    d[0] = 0;
    c[0] = 0;
    stk[0] = 0;
    int sp = 1, nb = 1, npend = 0, ntip = 0;
    bool ok = false, ovf = false;
    int32_t sink = -1;
    while (true) {
        const int slot = stk[--sp];
        const int32_t v = vis[slot];
        const int32_t dv = d[slot], cv = c[slot];
        bool fail = false;
        for (int64_t ai = first[v]; ai < first[v + 1]; ++ai) {
            const int32_t w = av[ai];
            if (w == v0) {  // back-arc aborts even when deleted
                fail = true;
                break;
            }
            if (adel[ai]) continue;
            const int32_t dd = wadd(dv, al[ai]);
            if (dd > max_dist) {
                fail = true;
                break;
            }
            int ws = -1;
            for (int k = 0; k < nb; ++k)
                if (vis[k] == w) {
                    ws = k;
                    break;
                }
            if (ws < 0) {
                if (nb == K) {
                    ovf = true;
                    fail = true;
                    break;
                }
                ws = nb++;
                vis[ws] = w;
                par[ws] = v;
                d[ws] = dd;
                c[ws] = 0;
                r[ws] = live_out[w ^ 1];
                ++npend;
            } else {
                const int32_t cw = c[ws], dw = d[ws];
                if (cv + 1 > cw || (cv + 1 == cw && dd > dw)) par[ws] = v;
                if (cv + 1 > cw) c[ws] = cv + 1;
                if (dd < dw) d[ws] = dd;
            }
            if (--r[ws] == 0) {
                if (first[w + 1] > first[w]) stk[sp++] = ws;
                else ++ntip;
                --npend;
            }
        }
        if (fail || sp == 0) break;
        if (sp == 1 && npend == 0) {
            ok = true;
            sink = vis[stk[0]];
            break;
        }
    }
    res[s] = (ok ? 1 : 0) | (ovf ? 2 : 0);
    res[S + s] = nb;
    res[2 * S + s] = ntip;
    res[3 * S + s] = sink;
}

}  // namespace

extern "C" int ma_bubble_bfs(const int64_t* first, const int32_t* av,
                             const int32_t* al, const uint8_t* adel,
                             const int32_t* live_out, const int32_t* sources,
                             int64_t S, int K, int max_dist, int32_t* res,
                             int32_t* vis, int32_t* par, int32_t* work,
                             cudaStream_t stream) {
    const int threads = 64;
    bubble_bfs_kernel<<<n_blocks(S, threads), threads, 0, stream>>>(
        first, av, al, adel, live_out, sources, S, K, max_dist, res, vis,
        par, work);
    return static_cast<int>(cudaGetLastError());
}
