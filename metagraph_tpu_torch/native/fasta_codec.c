/* Native FASTA/FastQ scanner + encoder.
 *
 * The host-side role of the reference's kseq.h/zlib reader
 * (metagraph/src/seq_io/sequence_io.cpp): stream file bytes into
 * alphabet-encoded uint8 code arrays with record separators, ready for
 * direct upload to the device extraction kernels. One pass, no Python
 * per-line overhead.
 *
 * The PyTorch port's own copy of metagraph_tpu/native/fasta_codec.c, built
 * at first use by native/loader.py (gcc -O3 -shared -fPIC) into
 * metagraph_tpu_torch/_build/ and loaded via ctypes; the pure-Python
 * parser (seqio/fasta.py) remains the read path.
 */

#include <stdint.h>
#include <stddef.h>

/* Encode FASTA ('>' headers) or FastQ ('@' headers) from a raw buffer.
 *
 * data/n        : file bytes
 * table         : 256-entry char -> code map (invalid = sep_code)
 * sep_code      : separator written between records (e.g. 255)
 * out           : output codes (capacity >= n + 1)
 * rec_offsets   : start offset of each record's codes within out
 * max_recs      : capacity of rec_offsets
 * n_recs_out    : number of records found
 * returns       : number of code bytes written, or -1 on overflow
 */
long fasta_encode(const unsigned char *data, long n,
                  const unsigned char *table, unsigned char sep_code,
                  unsigned char *out, long out_cap,
                  long *rec_offsets, long max_recs, long *n_recs_out)
{
    long o = 0, recs = 0, i = 0;
    /* sniff format from the first non-whitespace byte (a leading blank
     * line must not demote FastQ to FASTA) */
    long s = 0;
    while (s < n && (data[s] == '\n' || data[s] == '\r' ||
                     data[s] == ' ' || data[s] == '\t'))
        s++;
    if (s >= n) { *n_recs_out = 0; return 0; } /* all-whitespace file */
    int fastq = (data[s] == '@');
    if (data[s] != '>' && data[s] != '@')
        return -1; /* unknown format: let the caller fall back */
    while (i < n) {
        unsigned char c = data[i];
        if (c == '>' || (fastq && c == '@')) {
            /* header line: close the previous record */
            if (recs > 0) {
                if (o >= out_cap) return -1;
                out[o++] = sep_code;
            }
            if (recs >= max_recs) return -1;
            rec_offsets[recs++] = o;
            while (i < n && data[i] != '\n') i++;
            i++;
            /* sequence lines until next header (fasta) or '+' (fastq) */
            while (i < n) {
                if (data[i] == '>' || (!fastq && 0)) break;
                if (fastq && data[i] == '+') {
                    /* skip '+' line and the quality line */
                    while (i < n && data[i] != '\n') i++;
                    i++;
                    while (i < n && data[i] != '\n') i++;
                    i++;
                    break;
                }
                if (fastq && data[i] == '@') break;
                /* one sequence line */
                while (i < n) {
                    unsigned char b = data[i++];
                    if (b == '\n') break;
                    if (b == '\r' || b == ' ' || b == '\t') continue;
                    if (o >= out_cap) return -1;
                    out[o++] = table[b];
                }
            }
        } else {
            i++; /* stray bytes (blank lines) */
        }
    }
    if (recs > 0) {
        if (o >= out_cap) return -1;
        out[o++] = sep_code;
    }
    *n_recs_out = recs;
    return o;
}

/* 2-bit pack of a code array (codes 1..4 -> fields 0..3) with a sparse
 * invalid-position sidecar. Block layout: 2-bit field i of word j holds
 * code[i*nwords + j] - 1, so the device unpack is 16 contiguous
 * shift/mask slices with no transpose. Positions whose code is outside
 * 1..4 (separators, N bases, padding) are recorded in inval_idx and
 * packed as field 0; the device patches them back to the INVALID code.
 *
 * n must be a multiple of 16 (caller pads). Returns the number of
 * invalid positions found, or -1 if it exceeds max_inval (caller falls
 * back to the 4-bit pack).
 */
long pack2_codes(const unsigned char *codes, long n, unsigned int *words,
                 long *inval_idx, long max_inval)
{
    long nwords = n / 16;
    long ninv = 0;
    for (int i = 0; i < 16; i++) {
        const unsigned char *src = codes + (long)i * nwords;
        unsigned int sh = 2 * i;
        if (i == 0) {
            for (long j = 0; j < nwords; j++) {
                unsigned int c = src[j];
                unsigned int bad = (c - 1u) > 3u;
                if (bad) {
                    if (ninv >= max_inval) return -1;
                    inval_idx[ninv++] = (long)i * nwords + j;
                    c = 1;
                }
                words[j] = (c - 1u) & 3u;
            }
        } else {
            for (long j = 0; j < nwords; j++) {
                unsigned int c = src[j];
                unsigned int bad = (c - 1u) > 3u;
                if (bad) {
                    if (ninv >= max_inval) return -1;
                    inval_idx[ninv++] = (long)i * nwords + j;
                    c = 1;
                }
                words[j] |= ((c - 1u) & 3u) << sh;
            }
        }
    }
    return ninv;
}
