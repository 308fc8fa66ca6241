// 2-bit read packing for host->device upload (ops/readpack.pack_reads_fwd's
// hot loop). The numpy edition materializes ~200 MB of uint32 temporaries
// (astype + reshape + shifted sum) and costs ~1.6 s per 250k x 150bp batch;
// this loop is memory-bound at the input size (~37 MB) and runs in ~20 ms
// with OpenMP. Reference analog: the reference uploads raw char matrices
// (src/mapper.h loadReads [U]); packing ships ~9x fewer bytes.

#include <cstdint>
#include <cstring>

extern "C" {

// seqs: (k, row_stride) int8 codes (A..T=0..3, N>=4), reads in rows [0, k).
// packed: (half, Wp) uint32, 16 bases/word, base j at bit 2*(j%16).
// nmask:  (half, Wn) uint32, bit j%32 set where code is N OR column >= L
//         (pad); rows [k, half) are all-N.
// blob layout written directly: [packed | nmask | lengths] is assembled by
// the caller (pointers may be slices of one allocation).
void dy_pack_reads(const int8_t* seqs, int64_t k, int64_t row_stride,
                   int64_t L, int64_t half, uint32_t* packed,
                   uint32_t* nmask) {
    const int64_t Wp = (L + 15) / 16;
    const int64_t Wn = (L + 31) / 32;
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < half; r++) {
        uint32_t* p = packed + r * Wp;
        uint32_t* nm = nmask + r * Wn;
        if (r >= k) {                       // pad row: all-N
            memset(p, 0, Wp * sizeof(uint32_t));
            memset(nm, 0xff, Wn * sizeof(uint32_t));
            continue;
        }
        const int8_t* s = seqs + r * row_stride;
        for (int64_t w = 0; w < Wp; w++) {
            uint32_t acc = 0;
            const int64_t j0 = w * 16;
            const int64_t je = (j0 + 16 < L) ? j0 + 16 : L;
            for (int64_t j = j0; j < je; j++)
                acc |= (uint32_t)(s[j] & 3) << (2 * (j - j0));
            p[w] = acc;
        }
        for (int64_t w = 0; w < Wn; w++) {
            uint32_t acc = 0;
            const int64_t j0 = w * 32;
            const int64_t je = (j0 + 32 < L) ? j0 + 32 : L;
            for (int64_t j = j0; j < je; j++)
                acc |= (uint32_t)(s[j] >= 4) << (j - j0);
            // pad columns beyond L within this word
            if (je < j0 + 32)
                for (int64_t j = (je > j0 ? je : j0); j < j0 + 32; j++)
                    acc |= 1u << (j - j0);
            nm[w] = acc;
        }
    }
}

}  // extern "C"
