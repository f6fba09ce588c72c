// Native data loader: the host-side IO hot path.
//
// The reference does all ingest with per-character fgetc switch chains
// in every CLI main (e.g. build_index.c:54-88, single_align.c:441-474)
// — the equivalent native layer here is a small C++ library doing
// buffered table-driven encoding and 2-bit packing, exposed through a
// C ABI for ctypes (bwt_tpu/native/loader.py).  Encodings match
// bwt_tpu.codec exactly: genome non-ACGT -> 0 ('A'); read non-ACGT ->
// 5 ('N'); FastA per fil.cc (headers dropped, a/c/t uppercased,
// everything else -> 'G'); packing 16 little-endian 2-bit lanes per
// uint32 word.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct Tables {
  uint8_t genome[256];
  uint8_t read[256];
  Tables() {
    memset(genome, 0, sizeof genome);
    memset(read, 5, sizeof read);
    const char *nt = "ACGT";
    for (int i = 0; i < 4; ++i) {
      genome[(int)nt[i]] = (uint8_t)i;
      read[(int)nt[i]] = (uint8_t)i;
    }
  }
};
const Tables kTables;

std::vector<char> slurp(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return {};
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  rewind(f);
  std::vector<char> buf(n);
  if (n && fread(buf.data(), 1, n, f) != (size_t)n) buf.clear();
  fclose(f);
  return buf;
}

}  // namespace

extern "C" {

// ---- genome text -> codes -------------------------------------------------

// Returns the genome length (bytes, trailing newlines stripped); -1 on error.
long long bwt_genome_size(const char *path) {
  std::vector<char> buf = slurp(path);
  if (buf.empty()) return buf.capacity() ? 0 : -1;
  long long n = (long long)buf.size();
  while (n && (buf[n - 1] == '\n' || buf[n - 1] == '\r')) --n;
  return n;
}

// Fills out[0..n) with genome codes (non-ACGT -> 0).  Returns n or -1.
long long bwt_genome_load(const char *path, uint8_t *out, long long n) {
  std::vector<char> buf = slurp(path);
  if ((long long)buf.size() < n) return -1;
  const uint8_t *lut = kTables.genome;
  for (long long i = 0; i < n; ++i) out[i] = lut[(uint8_t)buf[i]];
  return n;
}

// ---- reads file (newline-delimited) ---------------------------------------

// Scans a reads file: number of nonempty lines and the longest line.
int bwt_reads_scan(const char *path, long long *n_reads, long long *max_len) {
  std::vector<char> buf = slurp(path);
  if (buf.empty() && bwt_genome_size(path) < 0) return -1;
  long long cnt = 0, mx = 0, cur = 0;
  for (char c : buf) {
    if (c == '\n') {
      if (cur) { ++cnt; if (cur > mx) mx = cur; }
      cur = 0;
    } else if (c != '\r') {
      ++cur;
    }
  }
  if (cur) { ++cnt; if (cur > mx) mx = cur; }
  *n_reads = cnt;
  *max_len = mx;
  return 0;
}

// Fills a (n_reads, stride) row-major code matrix (padded with 0) and
// per-read lengths.  Read codes: non-ACGT -> 5 ('N').
int bwt_reads_load(const char *path, uint8_t *codes, int32_t *lens,
                   long long n_reads, long long stride) {
  std::vector<char> buf = slurp(path);
  const uint8_t *lut = kTables.read;
  long long r = 0, cur = 0;
  memset(codes, 0, (size_t)(n_reads * stride));
  for (char c : buf) {
    if (c == '\n') {
      if (cur) {
        if (r >= n_reads) return -1;
        lens[r++] = (int32_t)cur;
      }
      cur = 0;
    } else if (c != '\r') {
      if (r < n_reads && cur < stride) codes[r * stride + cur] = lut[(uint8_t)c];
      ++cur;
    }
  }
  if (cur) {
    if (r >= n_reads) return -1;
    lens[r++] = (int32_t)cur;
  }
  return (int)(r == n_reads ? 0 : -1);
}

// ---- FastA -> plain sequence text (fil.cc semantics) ----------------------

// Converts in-memory FastA text; returns output length.  out may be
// null to query the size.
long long bwt_fasta_to_text(const char *fasta, long long n, char *out) {
  long long m = 0;
  bool in_header = false;
  for (long long i = 0; i < n; ++i) {
    char c = fasta[i];
    if (in_header) {
      if (c == '\n') in_header = false;
      continue;
    }
    if (c == '>') { in_header = true; continue; }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f')
      continue;
    char o;
    switch (c) {
      case 'A': case 'a': o = 'A'; break;
      case 'C': case 'c': o = 'C'; break;
      case 'T': case 't': o = 'T'; break;
      default: o = 'G';  // fil.cc:53-55 (includes G/g and N)
    }
    if (out) out[m] = o;
    ++m;
  }
  return m;
}

// ---- FastQ (4-line records: @name / seq / + / qual) -----------------------

// Scans a FastQ file: number of records and the longest sequence line.
int bwt_fastq_scan(const char *path, long long *n_reads, long long *max_len) {
  std::vector<char> buf = slurp(path);
  if (buf.empty() && bwt_genome_size(path) < 0) return -1;
  long long cnt = 0, mx = 0, cur = 0, line = 0;
  for (char c : buf) {
    if (c == '\n') {
      if (line % 4 == 1 && cur) { ++cnt; if (cur > mx) mx = cur; }
      ++line; cur = 0;
    } else if (c != '\r') {
      ++cur;
    }
  }
  if (line % 4 == 1 && cur) { ++cnt; if (cur > mx) mx = cur; }
  *n_reads = cnt;
  *max_len = mx;
  return 0;
}

// Fills codes/lens like bwt_reads_load but from the sequence lines of
// a FastQ file (quality lines are skipped; non-ACGT -> 5).
int bwt_fastq_load(const char *path, uint8_t *codes, int32_t *lens,
                   long long n_reads, long long stride) {
  std::vector<char> buf = slurp(path);
  const uint8_t *lut = kTables.read;
  long long r = 0, cur = 0, line = 0;
  memset(codes, 0, (size_t)(n_reads * stride));
  for (char c : buf) {
    if (c == '\n') {
      if (line % 4 == 1 && cur) {
        if (r >= n_reads) return -1;
        lens[r++] = (int32_t)cur;
      }
      ++line; cur = 0;
    } else if (c != '\r') {
      if (line % 4 == 1 && r < n_reads && cur < stride)
        codes[r * stride + cur] = lut[(uint8_t)c];
      ++cur;
    }
  }
  if (line % 4 == 1 && cur) {
    if (r >= n_reads) return -1;
    lens[r++] = (int32_t)cur;
  }
  return (int)(r == n_reads ? 0 : -1);
}

// ---- 2-bit packing (device word layout) -----------------------------------

// codes[0..n) in 0..3 -> words[0..ceil(n/16)), 16 LE 2-bit lanes/word.
void bwt_pack_words(const uint8_t *codes, long long n, uint32_t *words) {
  long long nwords = (n + 15) / 16;
  for (long long w = 0; w < nwords; ++w) {
    uint32_t v = 0;
    long long base = w * 16;
    long long lim = n - base < 16 ? n - base : 16;
    for (long long j = 0; j < lim; ++j)
      v |= (uint32_t)(codes[base + j] & 3) << (2 * j);
    words[w] = v;
  }
}

// Reference byte layout (big-endian within byte): serialization parity.
void bwt_pack_ref_bytes(const uint8_t *codes, long long n, uint8_t *bytes) {
  long long nbytes = (n + 3) / 4;
  for (long long b = 0; b < nbytes; ++b) {
    uint8_t v = 0;
    long long base = b * 4;
    long long lim = n - base < 4 ? n - base : 4;
    for (long long j = 0; j < lim; ++j)
      v |= (uint8_t)((codes[base + j] & 3) << (2 * (3 - j)));
    bytes[b] = v;
  }
}

}  // extern "C"
