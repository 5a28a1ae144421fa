/* The plain reference's loops that NumPy cannot run fast: miniasm's radix
 * order of the hits and arcs, and its reading of a PAF file.  Each is a
 * plain rendering of the C that miniasm runs; radix.py's radix_argsort and
 * paf.py's read_paf_numpy are the specs that the tests hold these
 * functions against.  Only system headers; the caller (native.py) builds
 * this file with the host's cc and calls it through ctypes. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------------- radix */

/* klib ksort.h, KRADIX_SORT_INIT with RS_MAX_BITS 8 and RS_MIN_SIZE 64,
 * on (key, index) pairs: MSD 8-bit digits from the top, buckets filled by
 * cycle leaders, an insertion sort for buckets of 64 or fewer. */

#define RS_MIN_SIZE 64
#define RS_MAX_BITS 8

typedef struct {
	uint64_t key;
	int64_t idx;
} rs_pair_t;

typedef struct {
	rs_pair_t *b, *e;
} rs_bucket_t;

static void rs_insertsort(rs_pair_t *beg, rs_pair_t *end)
{
	rs_pair_t *i, *j, tmp;
	for (i = beg + 1; i < end; ++i)
		if (i->key < (i - 1)->key) {
			tmp = *i;
			for (j = i; j > beg && tmp.key < (j - 1)->key; --j)
				*j = *(j - 1);
			*j = tmp;
		}
}

static void rs_sort(rs_pair_t *beg, rs_pair_t *end, int n_bits, int s)
{
	rs_pair_t *i;
	int size = 1 << n_bits, m = size - 1;
	rs_bucket_t *k, b[1 << RS_MAX_BITS], *be = b + size, *l;
	for (k = b; k != be; ++k)
		k->b = k->e = beg;
	for (i = beg; i != end; ++i)
		++b[i->key >> s & m].e;
	for (k = b + 1; k != be; ++k)
		k->e += (k - 1)->e - beg, k->b = (k - 1)->e;
	for (k = b; k != be;) {
		if (k->b != k->e) {
			if ((l = b + (k->b->key >> s & m)) != k) {
				rs_pair_t tmp = *k->b, swap;
				do {
					swap = tmp;
					tmp = *l->b;
					*l->b++ = swap;
					l = b + (tmp.key >> s & m);
				} while (l != k);
				*k->b++ = tmp;
			} else
				++k->b;
		} else
			++k;
	}
	for (b->b = beg, k = b + 1; k != be; ++k)
		k->b = (k - 1)->e;
	if (s) {
		s = s > n_bits ? s - n_bits : 0;
		for (k = b; k != be; ++k)
			if (k->e - k->b > RS_MIN_SIZE)
				rs_sort(k->b, k->e, n_bits, s);
			else if (k->e - k->b > 1)
				rs_insertsort(k->b, k->e);
	}
}

/* order[i]: the index of the key that miniasm's radix sort leaves at
 * place i.  Returns 0, or -1 when memory runs out. */
int pb_radix_order(const uint64_t *keys, int64_t n, int64_t *order)
{
	int64_t i;
	rs_pair_t *a = (rs_pair_t *)malloc((n > 0 ? n : 1) * sizeof(rs_pair_t));
	if (a == NULL)
		return -1;
	for (i = 0; i < n; ++i)
		a[i].key = keys[i], a[i].idx = i;
	if (n <= RS_MIN_SIZE)
		rs_insertsort(a, a + n);
	else
		rs_sort(a, a + n, RS_MAX_BITS, (8 - 1) * RS_MAX_BITS);
	for (i = 0; i < n; ++i)
		order[i] = a[i].idx;
	free(a);
	return 0;
}

/* ---------------------------------------------------------------- PAF */

/* miniasm's reading of a PAF buffer (paf.c, hit.c:70-107), by paf.py's
 * rules: a line counts when it has at least 10 tab-separated fields; each
 * number is read from its leading digits as the C's v = v * 10 + digit,
 * wrapping in uint32; a line of 10 fields takes the block length of the
 * line before it.  A record is kept when qe - qs and te - ts (uint32) are
 * at least min_span and ml at least min_match.  Only kept records give
 * their read names ids, in the order the names first appear, the query's
 * before the target's; a name is its bytes without trailing NULs, and its
 * read's length is the one at its first appearance.  With split != 0 the
 * names of the second half of the kept records come first, then those of
 * the first half (paf.py's intern="split"). */

static uint32_t pb_u32(const uint8_t *p, const uint8_t *e)
{
	uint32_t v = 0;
	for (; p < e && (uint8_t)(*p - '0') <= 9; ++p)
		v = v * 10u + (uint32_t)(*p - '0');
	return v;
}

static uint64_t pb_hash(const uint8_t *p, int64_t n)
{
	uint64_t h = 1469598103934665603ull;
	int64_t i;
	for (i = 0; i < n; ++i)
		h = (h ^ p[i]) * 1099511628211ull;
	return h ^ (h >> 29);
}

typedef struct {
	int64_t *off, *len;	/* each name's bytes in the buffer, by id */
	int64_t *aoff;		/* and in the arena, by id */
	uint8_t *arena;		/* the names' bytes, one after another */
	int64_t n, n_arena, cap_arena;	/* names so far; the arena's bytes */
	int32_t *slot;		/* open addressing: id + 1, 0 for empty */
	uint32_t *shash;	/* each slot's hash */
	uint64_t cap;
} pb_dict_t;

static int pb_dict_grow(pb_dict_t *d)
{
	uint64_t cap = d->cap ? d->cap << 1 : 1 << 16, j, i;
	int32_t *slot = (int32_t *)calloc(cap, sizeof(int32_t));
	uint32_t *shash = (uint32_t *)malloc(cap * sizeof(uint32_t));
	if (slot == NULL || shash == NULL) {
		free(slot);
		free(shash);
		return -1;
	}
	for (i = 0; i < d->cap; ++i)
		if (d->slot[i]) {
			for (j = d->shash[i] & (cap - 1); slot[j]; j = (j + 1) & (cap - 1))
				;
			slot[j] = d->slot[i], shash[j] = d->shash[i];
		}
	free(d->slot);
	free(d->shash);
	d->slot = slot, d->shash = shash, d->cap = cap;
	return 0;
}

/* The id of the name buf[off, off + len), a new one if it is not there
 * yet; -1 when memory runs out. */
static int64_t pb_dict_put(pb_dict_t *d, const uint8_t *buf, int64_t off,
			   int64_t len, int *is_new)
{
	uint64_t j;
	uint32_t h;
	const uint8_t *p = buf + off;
	if ((uint64_t)(d->n + 1) * 2 > d->cap && pb_dict_grow(d) < 0)
		return -1;
	h = (uint32_t)pb_hash(p, len);
	for (j = h & (d->cap - 1); d->slot[j]; j = (j + 1) & (d->cap - 1)) {
		int64_t id = d->slot[j] - 1;
		if (d->shash[j] == h && d->len[id] == len &&
		    memcmp(d->arena + d->aoff[id], p, len) == 0) {
			*is_new = 0;
			return id;
		}
	}
	if (d->n_arena + len > d->cap_arena) {
		int64_t c = d->cap_arena ? d->cap_arena : 1 << 20;
		uint8_t *a;
		while (c < d->n_arena + len)
			c <<= 1;
		if ((a = (uint8_t *)realloc(d->arena, c)) == NULL)
			return -1;
		d->arena = a, d->cap_arena = c;
	}
	memcpy(d->arena + d->n_arena, p, len);
	d->slot[j] = (int32_t)(d->n + 1), d->shash[j] = h;
	d->off[d->n] = off, d->len[d->n] = len, d->aoff[d->n] = d->n_arena;
	d->n_arena += len;
	*is_new = 1;
	return d->n++;
}

/* The lines of buf[0, n_buf): its newlines, and one more where it does
 * not end in one. */
int64_t pb_count_lines(const uint8_t *buf, int64_t n_buf)
{
	const uint8_t *p = buf, *end = buf + n_buf;
	int64_t n = 0;
	while (p < end && (p = (const uint8_t *)memchr(p, '\n', end - p)) != NULL)
		++n, ++p;
	return n + (n_buf > 0 && buf[n_buf - 1] != '\n');
}

/* Parses buf[0, n_buf).  cols: nine arrays of at least as many entries as
 * buf has lines, filled with the kept records' qid, qs, qe, tid, ts, te,
 * ml, bl, rev; name_off, name_len, name_rlen: at least twice as many,
 * filled with each name's bytes and its read's length, by id.  out[0] the
 * lines of 10 fields or more, out[1] the kept records, out[2] the names.
 * Returns 0, or -1 when memory runs out. */
int pb_paf_read(const uint8_t *buf, int64_t n_buf, int64_t min_span,
		int64_t min_match, int split, int64_t **cols,
		int64_t *name_off, int64_t *name_len, int64_t *name_rlen,
		int64_t *out)
{
	int64_t *qid = cols[0], *qs = cols[1], *qe = cols[2], *tid = cols[3];
	int64_t *ts = cols[4], *te = cols[5], *ml = cols[6], *bl = cols[7];
	int64_t *rev = cols[8];
	int64_t n_lines = 0, n = 0, cap = 0, last_bl = 0, p, i, half;
	int64_t *span = NULL;	/* per kept record: q off, q len, t off, t len */
	int64_t *rlen = NULL;	/* per kept record: ql, tl */
	const uint8_t *ls = buf, *end = buf + n_buf;
	pb_dict_t d = {name_off, name_len, NULL, NULL, 0, 0, 0, NULL, NULL, 0};
	int ret = -1, is_new;

	while (ls < end) {
		const uint8_t *le, *fs[12], *fe[12];
		uint32_t v[12];
		int nf = 0, k;
		/* fields 0-10 end at their tab; the 11th ends at the next tab or
		 * the line's end */
		fs[0] = ls;
		for (le = ls; le < end && *le != '\n'; ++le)
			if (*le == '\t' && nf < 11) {
				fe[nf++] = le;
				fs[nf] = le + 1;
			}
		fe[nf] = le;
		if (le > ls && nf >= 9) {
			for (k = 1; k <= 10; ++k)
				if (k != 4 && k != 5)
					v[k] = k <= nf ? pb_u32(fs[k], fe[k]) : 0;
			if (nf >= 10)
				last_bl = v[10];
			++n_lines;
			if ((int64_t)(uint32_t)(v[3] - v[2]) >= min_span &&
			    (int64_t)(uint32_t)(v[8] - v[7]) >= min_span &&
			    (int64_t)v[9] >= min_match) {
				if (n == cap) {
					int64_t c = cap ? cap << 1 : 1 << 16;
					int64_t *s2 = (int64_t *)realloc(span, c * 4 * sizeof(int64_t));
					int64_t *r2;
					if (s2 == NULL)
						goto done;
					span = s2;
					r2 = (int64_t *)realloc(rlen, c * 2 * sizeof(int64_t));
					if (r2 == NULL)
						goto done;
					rlen = r2, cap = c;
				}
				for (k = 0; k <= 5; k += 5) {
					const uint8_t *a = fs[k], *b = fe[k];
					while (b > a && b[-1] == 0)
						--b;
					span[4 * n + (k ? 2 : 0)] = a - buf;
					span[4 * n + (k ? 3 : 1)] = b - a;
				}
				rlen[2 * n] = v[1], rlen[2 * n + 1] = v[6];
				qs[n] = v[2], qe[n] = v[3], ts[n] = v[7], te[n] = v[8];
				ml[n] = v[9], bl[n] = last_bl;
				rev[n] = fe[4] > fs[4] && *fs[4] == '-';
				++n;
			}
		}
		ls = le + 1;
	}

	/* ids by first appearance in the stream q0 t0 q1 t1 ...; split: the
	 * stream's places from 2 * (n / 2) on first */
	half = split ? 2 * (n / 2) : 0;
	if ((d.aoff = (int64_t *)malloc((2 * n + 1) * sizeof(int64_t))) == NULL)
		goto done;
	for (i = 0; i < 2 * n; ++i) {
		int64_t id;
		p = i + half < 2 * n ? i + half : i + half - 2 * n;
		id = pb_dict_put(&d, buf, span[2 * p], span[2 * p + 1], &is_new);
		if (id < 0)
			goto done;
		if (is_new)
			name_rlen[id] = rlen[p];
		(p & 1 ? tid : qid)[p >> 1] = id;
	}
	out[0] = n_lines, out[1] = n, out[2] = d.n;
	ret = 0;
done:
	free(span);
	free(rlen);
	free(d.slot);
	free(d.shash);
	free(d.aoff);
	free(d.arena);
	return ret;
}
