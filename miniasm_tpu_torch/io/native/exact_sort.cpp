// Exact-permutation radix argsort (see ../../utils/exact_sort.py for the
// contract).  Re-implements the behavior of the reference's
// KRADIX_SORT_INIT (ksort.h:134-183) — MSD 8-bit digits, cycle-leader
// in-place distribution, stable insertion sort below 64 elements — over
// (u64 key, i64 index) pairs so the exact row permutation, including the
// order of equal keys, can be applied to SoA columns.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct KV {
    uint64_t key;
    int64_t idx;
};

constexpr int64_t kMinSize = 64;

inline void insert_sort(KV* beg, KV* end) {
    for (KV* i = beg + 1; i < end; ++i) {
        if (i->key < (i - 1)->key) {
            KV tmp = *i;
            KV* j = i;
            for (; j > beg && tmp.key < (j - 1)->key; --j) *j = *(j - 1);
            *j = tmp;
        }
    }
}

struct Bucket {
    KV* b;
    KV* e;
};

// One MSD distribution pass (histogram + cycle-leader in-place scatter on
// digit `s`); records the resulting bucket boundaries in `b`.  Identical
// element movement to ksort.h:150-171.
void rs_pass(KV* beg, KV* end, int n_bits, int s, Bucket* b) {
    const int size = 1 << n_bits, m = size - 1;
    Bucket* be = b + size;
    for (Bucket* k = b; k != be; ++k) k->b = k->e = beg;
    for (KV* i = beg; i != end; ++i) ++b[i->key >> s & m].e;
    for (Bucket* k = b + 1; k != be; ++k) {
        k->e += (k - 1)->e - beg;
        k->b = (k - 1)->e;
    }
    for (Bucket* k = b; k != be;) {
        if (k->b != k->e) {
            Bucket* l = b + (k->b->key >> s & m);
            if (l != k) {
                KV tmp = *k->b, swap;
                do {
                    swap = tmp;
                    tmp = *l->b;
                    *l->b++ = swap;
                    l = b + (tmp.key >> s & m);
                } while (l != k);
                *k->b++ = tmp;
            } else {
                ++k->b;
            }
        } else {
            ++k;
        }
    }
    b->b = beg;
    for (Bucket* k = b + 1; k != be; ++k) k->b = (k - 1)->e;
}

void rs_sort(KV* beg, KV* end, int n_bits, int s) {
    Bucket b[256];
    rs_pass(beg, end, n_bits, s, b);
    Bucket* be = b + (1 << n_bits);
    if (s) {
        s = s > n_bits ? s - n_bits : 0;
        for (Bucket* k = b; k != be; ++k) {
            if (k->e - k->b > kMinSize)
                rs_sort(k->b, k->e, n_bits, s);
            else if (k->e - k->b > 1)
                insert_sort(k->b, k->e);
        }
    }
}

// Parallel variant: the top distribution pass is sequential (its cycle-
// leader scatter is order-dependent), but once elements are distributed
// the 256 buckets never interact again, so worker threads can recurse
// into disjoint buckets concurrently — element movement (and thus the
// tie permutation) is identical to the sequential code.
void rs_sort_mt(KV* beg, KV* end, int n_bits, int s, int n_threads) {
    Bucket b[256];
    rs_pass(beg, end, n_bits, s, b);
    const int size = 1 << n_bits;
    if (!s) return;
    const int s2 = s > n_bits ? s - n_bits : 0;
    // skip through degenerate all-in-one-bucket levels sequentially so the
    // fan-out below actually has buckets to hand to the workers
    int live = 0;
    int64_t remaining = 0;
    Bucket* only = nullptr;
    for (int i = 0; i < size; ++i)
        if (b[i].e - b[i].b > 1) {
            ++live;
            remaining += b[i].e - b[i].b;
            only = &b[i];
        }
    if (live == 1 && only->e - only->b > kMinSize && s2) {
        rs_sort_mt(only->b, only->e, n_bits, s2, n_threads);
        return;
    }
    if (remaining < (1 << 16)) {  // not worth a thread pool
        for (int i = 0; i < size; ++i) {
            int64_t n = b[i].e - b[i].b;
            if (n > kMinSize)
                rs_sort(b[i].b, b[i].e, n_bits, s2);
            else if (n > 1)
                insert_sort(b[i].b, b[i].e);
        }
        return;
    }
    std::atomic<int> next{0};
    auto work = [&] {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= size) return;
            int64_t n = b[i].e - b[i].b;
            if (n > kMinSize)
                rs_sort(b[i].b, b[i].e, n_bits, s2);  // handles s2==0 itself
            else if (n > 1)
                insert_sort(b[i].b, b[i].e);
        }
    };
    std::vector<std::thread> ts;
    for (int w = 1; w < n_threads; ++w) ts.emplace_back(work);
    work();
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" void ma_radix_argsort_u64(uint64_t* keys, int64_t* idx, int64_t n) {
    KV* a = new KV[n];
    for (int64_t i = 0; i < n; ++i) a[i] = {keys[i], idx[i]};
    unsigned hw = std::thread::hardware_concurrency();
    int n_threads = hw ? static_cast<int>(hw) : 2;
    if (n <= kMinSize)
        insert_sort(a, a + n);
    else if (n >= (1 << 20) && n_threads > 1)
        rs_sort_mt(a, a + n, 8, 56, n_threads);
    else
        rs_sort(a, a + n, 8, 56);
    for (int64_t i = 0; i < n; ++i) {
        keys[i] = a[i].key;
        idx[i] = a[i].idx;
    }
    delete[] a;
}
