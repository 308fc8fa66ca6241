// Fast FASTQ chunk parser.
//
// Native analog of the reference's SeqAn FASTQ parsing behind
// file_prefetched.h [U] (SURVEY.md §2.5): the host-side input path must keep
// the device fed, so records are decoded straight into the dense (n, max_len)
// int8 code matrix the device consumes — no per-record Python objects.
//
// Build: g++ -O3 -march=native -shared -fPIC seqio.cpp -o libdyseqio.so

#include <cstdint>
#include <cstring>

namespace {

struct CodeTable {
    int8_t t[256];
    CodeTable() {
        std::memset(t, 4, sizeof(t));  // everything defaults to N
        t[uint8_t('A')] = t[uint8_t('a')] = 0;
        t[uint8_t('C')] = t[uint8_t('c')] = 1;
        t[uint8_t('G')] = t[uint8_t('g')] = 2;
        t[uint8_t('T')] = t[uint8_t('t')] = 3;
    }
};
const CodeTable CODES;

}  // namespace

extern "C" {

// Parse up to max_records FASTQ records from buf[0:len).
//
// Outputs:
//   seqs_out    (max_records * max_len) int8, caller-prefilled with 4 (N)
//   quals_out   (max_records * max_len) uint8, caller-prefilled
//   lengths_out (max_records) int32
//   name_off    (max_records + 1) int64 offsets into names_out
//   names_out   (names_cap) bytes
//   n_out       number of complete records parsed
// Returns bytes consumed (start of the first incomplete record), or -1 if
// the name buffer overflowed (caller retries with a bigger buffer).
int64_t dy_fastq_parse(const uint8_t* buf, int64_t len,
                       int32_t max_records, int32_t max_len,
                       int8_t* seqs_out, uint8_t* quals_out,
                       int32_t* lengths_out,
                       int64_t* name_off, uint8_t* names_out, int64_t names_cap,
                       int32_t* n_out) {
    int64_t pos = 0;
    int64_t name_pos = 0;
    int32_t rec = 0;
    name_off[0] = 0;

    while (rec < max_records) {
        // tolerate stray newlines between records (incl. chunk-boundary ones)
        while (pos < len && (buf[pos] == '\n' || buf[pos] == '\r')) pos++;
        int64_t rec_start = pos;
        // --- header line ---
        if (pos >= len || buf[pos] != '@') break;
        int64_t i = pos + 1;
        int64_t name_end = -1;
        while (i < len && buf[i] != '\n') {
            if (name_end < 0 && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\r'))
                name_end = i;
            i++;
        }
        if (i >= len) break;  // incomplete
        if (name_end < 0) name_end = i;
        int64_t nlen = name_end - (pos + 1);
        if (name_pos + nlen > names_cap) return -1;
        std::memcpy(names_out + name_pos, buf + pos + 1, size_t(nlen));
        name_pos += nlen;
        pos = i + 1;

        // --- sequence line ---
        int64_t seq_start = pos;
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len) { pos = rec_start; break; }
        int64_t slen = pos - seq_start;
        if (slen > 0 && buf[pos - 1] == '\r') slen--;
        if (slen > max_len) slen = max_len;  // truncate overlong reads
        int8_t* srow = seqs_out + int64_t(rec) * max_len;
        for (int64_t k = 0; k < slen; k++)
            srow[k] = CODES.t[buf[seq_start + k]];
        pos++;

        // --- '+' line ---
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len) { pos = rec_start; break; }
        pos++;

        // --- quality line ---
        int64_t q_start = pos;
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len && !(q_start + slen <= len)) { pos = rec_start; break; }
        int64_t qlen = (pos < len ? pos : len) - q_start;
        if (qlen > 0 && q_start + qlen <= len && buf[q_start + qlen - 1] == '\r')
            qlen--;
        if (qlen > slen) qlen = slen;
        std::memcpy(quals_out + int64_t(rec) * max_len, buf + q_start,
                    size_t(qlen));
        if (pos < len) pos++;

        lengths_out[rec] = int32_t(slen);
        rec++;
        name_off[rec] = name_pos;
    }
    *n_out = rec;
    return pos;
}

}  // extern "C"
