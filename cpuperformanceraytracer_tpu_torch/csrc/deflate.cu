// Deflate (RFC 1951) of members' bytes on the card: a 32 KiB slice a block (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes its checkpoint with
// np.savez_compressed, which deflates on the host. Added for the port's
// checkpoint (io/checkpoint.py): a 4K accumulator is 99.5 MB, which eight host
// threads deflate at about 100 MB/s while the card sits idle. Here the card
// deflates it where it lies and only the compressed bytes and the CRC-32s
// cross to the host. kernels/deflate.py holds the plain version, the same
// algorithm in numpy, whose bytes these equal.
//
// Input: members laid end to end; each becomes one raw deflate stream made of
// SLICE-byte slices, each of which may reach back WINDOW bytes into its member.
// Three launches:
//
//   slices_kernel  a block a slice: the slice and the WINDOW bytes before it in
//                  its member into shared memory; one warp chains the positions
//                  by a hash of their next 3 bytes (__match_any_sync orders a
//                  step's 32 positions, so each gets its nearest earlier one);
//                  each thread parses SUB bytes with zlib's one-step lazy
//                  evaluation over the first CHAIN candidates (tokens to global
//                  memory, counts into shared histograms); Moffat's in-place
//                  Huffman on the symbols ranked by (count, symbol) and miniz's
//                  Kraft repair give code lengths <= 15 (7 for the code-length
//                  code); a prefix sum of the threads' bit counts places every
//                  token, whose disjoint bits are OR-ed into shared memory; a
//                  stored block where that is smaller. All but a member's last
//                  slice end in a sync flush. Each thread's CRC-32 of its bytes,
//                  combined in a tree (zlib's multmodp / x2nmodp).
//   pack_kernel    a block a slice: its offset, the sum of the slices before it,
//                  and its bytes copied there, so the members' streams lie end
//                  to end in one buffer for one copy to the host.
//   finish_kernel  a thread a member: its bytes, and its CRC-32 combined from its
//                  slices' in order, from the CRC of what precedes it in its file.
//
// No atomics whose order shows: counts are sums, and OR-ed bits are disjoint,
// so the bytes are a function of the input alone.
//
// What bounds it: not bytes (a 4K save, 99.5 MB read and 73.5 MB written, is
// 0.052 ms at 3.35 TB/s) but the chaining warp's 2048 steps a slice while the
// block's other warps wait, then the parse's chain walks, dependent
// shared-memory loads in divergent threads; a slice's 207 KB of shared memory
// keeps one block on an SM. The chains and the code building in launches of
// their own would run several slices an SM (18 ms of kernels a 4K save against
// about 35 here), a few per cent of a checkpointed interval: not worth the
// global chains and the record format between the kernels that they need.
//
// The host build (tests/test_torch_deflate.py) defines DFL_DEV, DFL_SMEM,
// DFL_CONST and the CUDA built-ins used here and runs the kernels with threads.

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DFL_DEV __device__ __forceinline__
#define DFL_SMEM(p) extern __shared__ __align__(16) unsigned char p[]
#define DFL_CONST __constant__ const
#endif

namespace dfl {

constexpr int SLICE = 1 << 15;     // bytes of a member one block deflates
constexpr int WINDOW = 1 << 15;    // how far back a match may reach
constexpr int REGION = SLICE + WINDOW;
constexpr int THREADS = 256;       // each parses SUB bytes
constexpr int SUB = SLICE / THREADS;
constexpr int HASH_BITS = 13;
constexpr int CHAIN = 16;          // candidates tried at a position
constexpr int LAZY = 32;           // a match this long is taken without a lazy look
constexpr int TOO_FAR = 4096;      // a 3-byte match further back is not taken
constexpr int SLOT = SLICE + 256;  // bytes of a slice's output
constexpr uint32_t POLY = 0xEDB88320u;
constexpr int FINISH_THREADS = 32;

// x^(2^n) mod the CRC-32 polynomial (zlib's x2n_table)
DFL_CONST uint32_t X2N[32] = {
    0x40000000, 0x20000000, 0x08000000, 0x00800000, 0x00008000, 0xedb88320, 0xb1e6b092,
    0xa06a2517, 0xed627dae, 0x88d14467, 0xd7bbfe6a, 0xec447f11, 0x8e7ea170, 0x6427800e,
    0x4d47bae0, 0x09fe548f, 0x83852d0f, 0x30362f1a, 0x7b5a9cc3, 0x31fec169, 0x9fec022a,
    0x6c8dedc4, 0x15d6874d, 0x5fde7a4e, 0xbad90e37, 0x2e4e5eef, 0x4eaba214, 0xa8a472c0,
    0x429a969e, 0x148d302a, 0xc40ba6d0, 0xc4e22c3c};

// what a block keeps beside the bytes, the chains and the hash heads
struct Misc {
    uint32_t crc_table[256];
    uint32_t ll_freq[286];   // literal/length counts (EOB's 1 included)
    uint32_t d_freq[30];
    uint32_t cl_freq[19];
    uint32_t hfreq[288];     // code_lengths' scratch: counts, two symbols at least
    uint32_t hkey[288];      //   Moffat's array
    uint16_t hsym[288];      //   the used symbols by (count, symbol)
    uint16_t ll_code[286];   // canonical codes, bit-reversed
    uint16_t d_code[30];
    uint16_t cl_code[19];
    uint8_t ll_len[288];
    uint8_t d_len[32];
    uint8_t cl_len[20];
    uint8_t rle_sym[320];    // the code-length symbols of the header
    uint8_t rle_extra[320];
    uint32_t ntok[THREADS];  // tokens a thread parsed
    uint32_t bits[THREADS];  // their bits, then the bit where they start
    uint32_t crc[THREADS];   // CRC-32 of a thread's bytes, then of the tree's
    uint32_t crc_len[THREADS];
    int count[34];
    int hn, rle_n, hlit, hdist, hclen;
    uint32_t header_bits, token_bits;
    int out_bytes, dynamic;
};

// shared memory: bytes, chains (after the parse: the output's bits), hash heads, Misc
constexpr int DATA_OFF = 0;
constexpr int PREV_OFF = REGION + 16;
constexpr int HEAD_OFF = PREV_OFF + 2 * REGION;
constexpr int MISC_OFF = HEAD_OFF + 2 * (1 << HASH_BITS);
constexpr int SMEM_BYTES = MISC_OFF + (int)sizeof(Misc);
constexpr int PACK_SMEM = THREADS * 8;
constexpr int FINISH_SMEM = 16;

DFL_DEV int imin(int a, int b) { return a < b ? a : b; }

DFL_DEV uint32_t hash3(const uint8_t* d, int p) {
    const uint32_t w = (uint32_t)d[p] | (uint32_t)d[p + 1] << 8 | (uint32_t)d[p + 2] << 16;
    return (w * 0x9E3779B1u) >> (32 - HASH_BITS);
}

// deflate's length symbol index (0-28, symbol 257 + it), its base and extra bits
DFL_DEV int len_code(int n) {
    if (n < 11) return n - 3;
    if (n == 258) return 28;
    const int x = n - 3, k = 31 - __clz((unsigned)x);
    return 4 * (k - 1) + ((x >> (k - 2)) & 3);
}
DFL_DEV int len_extra(int i) { return (i < 8 || i == 28) ? 0 : (i >> 2) - 1; }
DFL_DEV int len_base(int i) {
    if (i < 8) return i + 3;
    if (i == 28) return 258;
    return 3 + ((4 + (i & 3)) << ((i >> 2) - 1));
}
DFL_DEV int dist_code(int d) {
    const int x = d - 1;
    if (x < 2) return x;
    const int k = 31 - __clz((unsigned)x);
    return 2 * k + ((x >> (k - 1)) & 1);
}
DFL_DEV int dist_extra(int c) { return c < 4 ? 0 : (c >> 1) - 1; }
DFL_DEV int dist_base(int c) { return c < 4 ? c + 1 : ((2 + (c & 1)) << ((c >> 1) - 1)) + 1; }
DFL_DEV int cl_extra(int s) { return s == 16 ? 2 : s == 17 ? 3 : s == 18 ? 7 : 0; }

// CRC-32 arithmetic (zlib's crc32.c): a * b mod P, and x^(8 n) mod P
DFL_DEV uint32_t multmodp(uint32_t a, uint32_t b) {
    uint32_t m = 1u << 31, p = 0;
    for (;;) {
        if (a & m) {
            p ^= b;
            if ((a & (m - 1)) == 0) break;
        }
        m >>= 1;
        b = (b & 1) ? (b >> 1) ^ POLY : b >> 1;
    }
    return p;
}
DFL_DEV uint32_t x8nmodp(uint32_t n) {
    uint32_t p = 1u << 31;
    for (int k = 3; n; n >>= 1, ++k)
        if (n & 1) p = multmodp(X2N[k & 31], p);
    return p;
}
// crc32(A || B) of crc32(A), crc32(B) and B's length
DFL_DEV uint32_t crc_combine(uint32_t a, uint32_t b, uint32_t len_b) {
    return len_b ? multmodp(x8nmodp(len_b), a) ^ b : a;
}

// the longest of the first CHAIN candidates down p's chain, at most `limit`
// bytes, the nearest on ties: length << 16 | distance, 0 for none
DFL_DEV uint32_t best_match(const uint8_t* data, const uint16_t* prev, int p, int limit) {
    if (limit < 3) return 0;
    int best_len = 0, best_dist = 0, dist = 0, q = p;
    for (int k = 0; k < CHAIN; ++k) {
        const int d = prev[q];
        if (d == 0) break;
        dist += d;
        if (dist > WINDOW) break;
        q -= d;
        if (data[q + best_len] != data[p + best_len]) continue;   // it cannot be longer
        int n = 0;
        while (n < limit && data[q + n] == data[p + n]) ++n;
        if (n > best_len) {
            best_len = n;
            best_dist = dist;
            if (n == limit) break;
        }
    }
    if (best_len < 3 || (best_len == 3 && best_dist > TOO_FAR)) return 0;
    return (uint32_t)best_len << 16 | (uint32_t)best_dist;
}

// code lengths of a prefix code for freq[0, n), none over max_len (the whole
// block calls it): two symbols used at least (the lowest unused count 1);
// used symbols ranked by (count, symbol); Moffat and Katajainen's in-place
// Huffman; lengths cut to max_len and the Kraft sum mended (miniz); the most
// frequent symbols take the shortest codes
DFL_DEV void code_lengths(const uint32_t* freq, int n, int max_len, uint8_t* len, Misc& m,
                          int tid) {
    for (int s = tid; s < n; s += THREADS) m.hfreq[s] = freq[s];
    __syncthreads();
    if (tid == 0) {
        int used = 0;
        for (int s = 0; s < n; ++s) used += m.hfreq[s] != 0;
        for (int s = 0; s < n && used < 2; ++s)
            if (!m.hfreq[s]) {
                m.hfreq[s] = 1;
                ++used;
            }
        m.hn = used;
    }
    __syncthreads();
    for (int s = tid; s < n; s += THREADS) {
        len[s] = 0;
        const uint32_t f = m.hfreq[s];
        if (f) {
            int r = 0;
            for (int j = 0; j < n; ++j) {
                const uint32_t g = m.hfreq[j];
                r += g != 0 && (g < f || (g == f && j < s));
            }
            m.hsym[r] = (uint16_t)s;
        }
    }
    __syncthreads();
    if (tid == 0) {
        const int k = m.hn;
        uint32_t* a = m.hkey;
        for (int i = 0; i < k; ++i) a[i] = m.hfreq[m.hsym[i]];
        a[0] += a[1];
        int root = 0, leaf = 2;
        for (int next = 1; next < k - 1; ++next) {
            if (leaf >= k || a[root] < a[leaf]) {
                a[next] = a[root];
                a[root++] = next;
            } else {
                a[next] = a[leaf++];
            }
            if (leaf >= k || (root < next && a[root] < a[leaf])) {
                a[next] += a[root];
                a[root++] = next;
            } else {
                a[next] += a[leaf++];
            }
        }
        a[k - 2] = 0;
        for (int next = k - 3; next >= 0; --next) a[next] = a[a[next]] + 1;
        int avbl = 1, used = 0, depth = 0, next = k - 1;
        root = k - 2;
        while (avbl > 0) {
            while (root >= 0 && (int)a[root] == depth) {
                ++used;
                --root;
            }
            while (avbl > used) {
                a[next--] = depth;
                --avbl;
            }
            avbl = 2 * used;
            ++depth;
            used = 0;
        }
        int* count = m.count;
        for (int i = 0; i < 34; ++i) count[i] = 0;
        for (int i = 0; i < k; ++i) ++count[imin((int)a[i], max_len)];
        uint32_t total = 0;
        for (int i = 1; i <= max_len; ++i) total += (uint32_t)count[i] << (max_len - i);
        while (total != (1u << max_len)) {
            --count[max_len];
            for (int i = max_len - 1; i > 0; --i)
                if (count[i]) {
                    --count[i];
                    count[i + 1] += 2;
                    break;
                }
            --total;
        }
        int j = k;
        for (int i = 1; i <= max_len; ++i)
            for (int c = count[i]; c > 0; --c) len[m.hsym[--j]] = (uint8_t)i;
    }
    __syncthreads();
}

// canonical codes of len[0, n), bit-reversed for deflate's LSB-first packing
DFL_DEV void canonical(const uint8_t* len, int n, uint16_t* code) {
    int count[16] = {0}, next[16];
    for (int s = 0; s < n; ++s) ++count[len[s]];
    count[0] = 0;
    int c = 0;
    for (int i = 1; i < 16; ++i) {
        c = (c + count[i - 1]) << 1;
        next[i] = c;
    }
    for (int s = 0; s < n; ++s)
        if (len[s]) code[s] = (uint16_t)(__brev((unsigned)next[len[s]]++) >> (32 - len[s]));
}

// OR `width` (<= 16) bits of `value` into the bit buffer at bit `at`
DFL_DEV void put_bits(uint32_t* buf, uint32_t at, uint32_t value, int width) {
    if (!width) return;
    const uint32_t w = at >> 5, sh = at & 31;
    atomicOr(&buf[w], value << sh);
    if (sh + width > 32) atomicOr(&buf[w + 1], value >> (32 - sh));
}

// one slice: jobs[4 * slice] = {offset of its first byte in `in`, bytes of its
// member before it that it may reach (<= WINDOW), its bytes, 1 if its member's last}
__global__ void __launch_bounds__(THREADS, 1)
slices_kernel(const uint8_t* __restrict__ in, const long long* __restrict__ jobs,
              uint32_t* __restrict__ tokens, uint8_t* __restrict__ slots,
              int* __restrict__ out_len, uint32_t* __restrict__ crcs) {
    DFL_SMEM(smem);
    uint8_t* data = smem + DATA_OFF;
    uint16_t* prev = reinterpret_cast<uint16_t*>(smem + PREV_OFF);
    uint16_t* head = reinterpret_cast<uint16_t*>(smem + HEAD_OFF);
    Misc& m = *reinterpret_cast<Misc*>(smem + MISC_OFF);
    const int tid = threadIdx.x;
    const int slice = blockIdx.x;
    const long long* job = jobs + 4 * (long long)slice;
    const int window = (int)job[1], n = (int)job[2];
    const bool final = job[3] != 0;
    const int R = window + n;
    const uint8_t* src = in + (job[0] - window);

    for (int i = tid; i < R; i += THREADS) data[i] = src[i];
    for (int i = R + tid; i < REGION + 16; i += THREADS) data[i] = 0;
    for (int i = tid; i < (1 << HASH_BITS); i += THREADS) head[i] = 0;
    {
        uint32_t c = (uint32_t)tid;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ POLY : c >> 1;
        m.crc_table[tid] = c;
    }
    for (int i = tid; i < 286; i += THREADS) m.ll_freq[i] = 0;
    if (tid < 30) m.d_freq[tid] = 0;
    __syncthreads();

    // chains: prev[p] is the distance back to the nearest earlier position with
    // p's hash (head holds the latest such position + 1), 0 for none in WINDOW
    if (tid < 32) {
        const int lane = tid;
        const unsigned below = (1u << lane) - 1u;
        for (int base = 0; base < R; base += 32) {
            const int p = base + lane;
            const bool has = p + 2 < R;
            const uint32_t key = has ? hash3(data, p) : 0x10000u + (uint32_t)lane;
            const unsigned group = __match_any_sync(0xFFFFFFFFu, key);
            const unsigned lower = group & below;
            int q = -1;
            if (has) q = lower ? base + 31 - __clz(lower) : (int)head[key] - 1;
            __syncwarp();
            if (p < R) prev[p] = (q >= 0 && p - q <= WINDOW) ? (uint16_t)(p - q) : 0;
            if (has && (group >> lane) == 1u) head[key] = (uint16_t)(p + 1);
            __syncwarp();
        }
    }
    __syncthreads();

    // the parse of bytes [a, b), to tokens[slice][k][tid]: a literal its byte, a
    // match 1 << 31 | length << 16 | distance; a match stops at b
    uint32_t* tok = tokens + (long long)slice * SLICE + tid;
    const int a = window + tid * SUB;
    const int b = imin(a + SUB, R);
    int ntok = 0;
    {
        int p = a;
        uint32_t cur = p < b ? best_match(data, prev, p, b - p) : 0;
        while (p < b) {
            const int len = (int)(cur >> 16);
            if (len == 0) {
                tok[(long long)ntok++ * THREADS] = data[p];
                atomicAdd(&m.ll_freq[data[p]], 1u);
                if (++p < b) cur = best_match(data, prev, p, b - p);
                continue;
            }
            if (len < LAZY && p + 1 < b) {
                const uint32_t next = best_match(data, prev, p + 1, b - p - 1);
                if ((int)(next >> 16) > len) {
                    tok[(long long)ntok++ * THREADS] = data[p];
                    atomicAdd(&m.ll_freq[data[p]], 1u);
                    ++p;
                    cur = next;
                    continue;
                }
            }
            const int dist = (int)(cur & 0xFFFF);
            tok[(long long)ntok++ * THREADS] = 1u << 31 | cur;
            atomicAdd(&m.ll_freq[257 + len_code(len)], 1u);
            atomicAdd(&m.d_freq[dist_code(dist)], 1u);
            p += len;
            if (p < b) cur = best_match(data, prev, p, b - p);
        }
    }
    m.ntok[tid] = (uint32_t)ntok;
    {
        uint32_t c = 0xFFFFFFFFu;
        for (int i = a; i < b; ++i) c = m.crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
        m.crc[tid] = ~c;
        m.crc_len[tid] = (uint32_t)(b > a ? b - a : 0);
    }
    __syncthreads();
    if (tid == 0) m.ll_freq[256] = 1;   // the end of the block
    __syncthreads();

    // the codes
    code_lengths(m.ll_freq, 286, 15, m.ll_len, m, tid);
    code_lengths(m.d_freq, 30, 15, m.d_len, m, tid);
    if (tid == 0) {
        int hlit = 286, hdist = 30;
        while (!m.ll_len[hlit - 1]) --hlit;
        while (!m.d_len[hdist - 1]) --hdist;
        m.hlit = hlit;
        m.hdist = hdist;
        // run lengths of the literal/length lengths, then the distance lengths
        const int total = hlit + hdist;
        int r = 0, i = 0;
        for (int s = 0; s < 19; ++s) m.cl_freq[s] = 0;
        while (i < total) {
            const int v = i < hlit ? m.ll_len[i] : m.d_len[i - hlit];
            int run = 1;
            while (i + run < total &&
                   (i + run < hlit ? m.ll_len[i + run] : m.d_len[i + run - hlit]) == v)
                ++run;
            i += run;
            if (v == 0) {
                while (run >= 11) {
                    const int k = imin(run, 138);
                    m.rle_sym[r] = 18;
                    m.rle_extra[r++] = (uint8_t)(k - 11);
                    run -= k;
                }
                if (run >= 3) {
                    m.rle_sym[r] = 17;
                    m.rle_extra[r++] = (uint8_t)(run - 3);
                    run = 0;
                }
            } else {
                m.rle_sym[r] = (uint8_t)v;
                m.rle_extra[r++] = 0;
                --run;
                while (run >= 3) {
                    const int k = imin(run, 6);
                    m.rle_sym[r] = 16;
                    m.rle_extra[r++] = (uint8_t)(k - 3);
                    run -= k;
                }
            }
            for (; run > 0; --run) {
                m.rle_sym[r] = (uint8_t)v;
                m.rle_extra[r++] = 0;
            }
        }
        m.rle_n = r;
        for (int k = 0; k < r; ++k) ++m.cl_freq[m.rle_sym[k]];
    }
    __syncthreads();
    code_lengths(m.cl_freq, 19, 7, m.cl_len, m, tid);
    if (tid == 0) {
        const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
        int hclen = 19;
        while (hclen > 4 && !m.cl_len[order[hclen - 1]]) --hclen;
        m.hclen = hclen;
        canonical(m.ll_len, 286, m.ll_code);
        canonical(m.d_len, 30, m.d_code);
        canonical(m.cl_len, 19, m.cl_code);
        uint32_t header = 3 + 5 + 5 + 4 + 3 * hclen;
        for (int k = 0; k < m.rle_n; ++k)
            header += m.cl_len[m.rle_sym[k]] + cl_extra(m.rle_sym[k]);
        uint32_t body = 0;
        for (int s = 0; s < 286; ++s)
            body += m.ll_freq[s] * (m.ll_len[s] + (s > 256 ? len_extra(s - 257) : 0));
        for (int c = 0; c < 30; ++c) body += m.d_freq[c] * (m.d_len[c] + dist_extra(c));
        m.header_bits = header;
        m.token_bits = body;
        const uint32_t end = header + body;
        const int dynamic = final ? (int)((end + 7) >> 3) : (int)((end + 3 + 7) >> 3) + 4;
        const int stored = 5 + n;
        m.dynamic = dynamic < stored;
        m.out_bytes = dynamic < stored ? dynamic : stored;
    }
    __syncthreads();

    uint8_t* slot = slots + (long long)slice * SLOT;
    if (!m.dynamic) {
        if (tid == 0) {
            slot[0] = final ? 1 : 0;
            slot[1] = (uint8_t)(n & 0xFF);
            slot[2] = (uint8_t)(n >> 8);
            slot[3] = (uint8_t)(~n & 0xFF);
            slot[4] = (uint8_t)((~n >> 8) & 0xFF);
        }
        for (int i = tid; i < n; i += THREADS) slot[5 + i] = data[window + i];
    } else {
        // each thread's bits, their exclusive prefix sum, then every field OR-ed in
        uint32_t mine = 0;
        for (uint32_t k = 0; k < m.ntok[tid]; ++k) {
            const uint32_t t = tok[(long long)k * THREADS];
            if (t >> 31) {
                const int lc = len_code((int)((t >> 16) & 0x1FF));
                const int dc = dist_code((int)(t & 0xFFFF));
                mine += m.ll_len[257 + lc] + len_extra(lc) + m.d_len[dc] + dist_extra(dc);
            } else {
                mine += m.ll_len[t];
            }
        }
        m.bits[tid] = mine;
        uint32_t* buf = reinterpret_cast<uint32_t*>(smem + PREV_OFF);
        const int words = (m.out_bytes + 3) / 4 + 1;
        __syncthreads();   // the parse's reads of prev are over
        for (int i = tid; i < words; i += THREADS) buf[i] = 0;
        if (tid == 0) {
            uint32_t at = m.header_bits;
            for (int t = 0; t < THREADS; ++t) {
                const uint32_t n_bits = m.bits[t];
                m.bits[t] = at;
                at += n_bits;
            }
        }
        __syncthreads();
        if (tid == 0) {
            const uint8_t order[19] = {16, 17, 18, 0,  8, 7,  9, 6,  10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};
            uint32_t at = 0;
            put_bits(buf, at, (final ? 1u : 0u) | 2u << 1, 3);
            at += 3;
            put_bits(buf, at, (uint32_t)(m.hlit - 257), 5);
            at += 5;
            put_bits(buf, at, (uint32_t)(m.hdist - 1), 5);
            at += 5;
            put_bits(buf, at, (uint32_t)(m.hclen - 4), 4);
            at += 4;
            for (int k = 0; k < m.hclen; ++k, at += 3) put_bits(buf, at, m.cl_len[order[k]], 3);
            for (int k = 0; k < m.rle_n; ++k) {
                const int s = m.rle_sym[k];
                put_bits(buf, at, m.cl_code[s], m.cl_len[s]);
                at += m.cl_len[s];
                put_bits(buf, at, m.rle_extra[k], cl_extra(s));
                at += cl_extra(s);
            }
            at = m.header_bits + m.token_bits - m.ll_len[256];
            put_bits(buf, at, m.ll_code[256], m.ll_len[256]);
            if (!final) {   // an empty stored block after 3 bits and the pad
                const uint32_t aligned = (m.header_bits + m.token_bits + 3 + 7) & ~7u;
                put_bits(buf, aligned + 16, 0xFFFFu, 16);
            }
        }
        uint32_t at = m.bits[tid];
        for (uint32_t k = 0; k < m.ntok[tid]; ++k) {
            const uint32_t t = tok[(long long)k * THREADS];
            if (t >> 31) {
                const int len = (int)((t >> 16) & 0x1FF), dist = (int)(t & 0xFFFF);
                const int lc = len_code(len), dc = dist_code(dist);
                put_bits(buf, at, m.ll_code[257 + lc], m.ll_len[257 + lc]);
                at += m.ll_len[257 + lc];
                put_bits(buf, at, (uint32_t)(len - len_base(lc)), len_extra(lc));
                at += len_extra(lc);
                put_bits(buf, at, m.d_code[dc], m.d_len[dc]);
                at += m.d_len[dc];
                put_bits(buf, at, (uint32_t)(dist - dist_base(dc)), dist_extra(dc));
                at += dist_extra(dc);
            } else {
                put_bits(buf, at, m.ll_code[t], m.ll_len[t]);
                at += m.ll_len[t];
            }
        }
        __syncthreads();
        uint32_t* out = reinterpret_cast<uint32_t*>(slot);
        for (int i = tid; i < (m.out_bytes + 3) / 4; i += THREADS) out[i] = buf[i];
    }

    // the slice's CRC-32: the threads' combined in a tree
    for (int stride = 1; stride < THREADS; stride <<= 1) {
        __syncthreads();
        if ((tid & (2 * stride - 1)) == 0) {
            m.crc[tid] = crc_combine(m.crc[tid], m.crc[tid + stride], m.crc_len[tid + stride]);
            m.crc_len[tid] += m.crc_len[tid + stride];
        }
    }
    __syncthreads();
    if (tid == 0) {
        out_len[slice] = m.out_bytes;
        crcs[slice] = m.crc[0];
    }
}

// a block a slice: its bytes to the sum of the slices' before it
__global__ void __launch_bounds__(THREADS)
pack_kernel(const uint8_t* __restrict__ slots, const int* __restrict__ out_len,
            uint8_t* __restrict__ packed) {
    DFL_SMEM(smem);
    long long* part = reinterpret_cast<long long*>(smem);
    const int tid = threadIdx.x, slice = blockIdx.x;
    long long sum = 0;
    for (int j = tid; j < slice; j += THREADS) sum += out_len[j];
    part[tid] = sum;
    for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
        __syncthreads();
        if (tid < stride) part[tid] += part[tid + stride];
    }
    __syncthreads();
    const long long at = part[0];
    const uint8_t* from = slots + (long long)slice * SLOT;
    for (int i = tid; i < out_len[slice]; i += THREADS) packed[at + i] = from[i];
}

// a thread a member: members[3 * i] = {its first slice, its slices, the CRC-32
// to start from}; out[2 * i] = {its bytes, its CRC-32}
__global__ void finish_kernel(const long long* __restrict__ jobs,
                              const long long* __restrict__ members, int n_members,
                              const int* __restrict__ out_len, const uint32_t* __restrict__ crcs,
                              long long* __restrict__ out) {
    const uint32_t whole = x8nmodp(SLICE);
    for (int i = threadIdx.x; i < n_members; i += FINISH_THREADS) {
        const long long first = members[3 * i], count = members[3 * i + 1];
        uint32_t crc = (uint32_t)members[3 * i + 2];
        long long bytes = 0;
        for (long long s = first; s < first + count; ++s) {
            const uint32_t len = (uint32_t)jobs[4 * s + 2];
            crc = multmodp(len == SLICE ? whole : x8nmodp(len), crc) ^ crcs[s];
            bytes += out_len[s];
        }
        out[2 * i] = bytes;
        out[2 * i + 1] = crc;
    }
}

}  // namespace dfl

#ifdef __CUDACC__
extern "C" int cprt_deflate(const uint8_t* in, const long long* jobs, int n_slices,
                            const long long* members, int n_members, uint32_t* tokens,
                            uint8_t* slots, int* out_len, uint32_t* crcs, uint8_t* packed,
                            long long* member_out, void* stream) {
    using namespace dfl;
    static_assert(SMEM_BYTES <= 232448, "a slice's shared memory exceeds the SM's");
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaFuncSetAttribute(
        slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (n_slices > 0) {
        slices_kernel<<<n_slices, THREADS, SMEM_BYTES, s>>>(in, jobs, tokens, slots, out_len, crcs);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        pack_kernel<<<n_slices, THREADS, PACK_SMEM, s>>>(slots, out_len, packed);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    finish_kernel<<<1, FINISH_THREADS, 0, s>>>(jobs, members, n_members, out_len, crcs, member_out);
    return (int)cudaGetLastError();
}
#endif
