// Native multi-threaded FASTA parser + nucleotide encoder.
//
// Reproduces the reference front-end semantics exactly like io/fasta.py
// (the numpy path is the tested oracle; this file is the fast path):
//   - streaming multi-record parse, CR/LF-safe
//     (reference: ChromListMaker.cpp:23-47, :92-120)
//   - uppercase + digit encoding A,C,G,T -> 0..3 with IUPAC codes mapped to
//     fixed bases (ChromosomeOneDigit.cpp:59-85)
//   - N-run removal into inclusive [start, end] segments, gaps < 10 merged,
//     segments < 20 bp dropped (Chromosome.cpp:162-226)
//   - segments chunked to <= 1 Mbp, last fragment absorbs the remainder
//     (Chromosome.cpp:228-258)
//   - N positions OUTSIDE merged segments keep the literal 'N' byte (78);
//     N's absorbed into segments encode via the map (N -> C)
//     (ChromosomeOneDigit.cpp:95-144)
//
// C ABI for ctypes. Two-phase parallel over records: measure lengths,
// prefix-sum, then encode into one shared codes buffer.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o _fasta_parser.so fasta_parser.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t SEG_LENGTH = 1000000;
constexpr int64_t MIN_SEG = 20;
constexpr int64_t MERGE_GAP = 10;
constexpr uint8_t N_BYTE = 'N';
constexpr uint8_t BAD = 255;
constexpr uint8_t NCODE = 254;  // internal marker: this byte is an 'N'

// raw byte -> digit code (uppercasing folded in). 'N' gets NCODE so the
// segment pass can find runs in the same sweep; it is rewritten to 1 ('C')
// inside segments and 78 outside, matching the reference.
struct Luts {
  uint8_t code[256];
  Luts() {
    for (int i = 0; i < 256; ++i) code[i] = BAD;
    auto set = [&](char c, uint8_t v) {
      code[(uint8_t)c] = v;
      code[(uint8_t)(c + 32)] = v;  // lowercase
    };
    set('A', 0); set('C', 1); set('G', 2); set('T', 3);
    set('R', 2); set('Y', 1); set('M', 0); set('K', 3);
    set('S', 2); set('W', 3); set('H', 1); set('B', 3);
    set('V', 0); set('D', 3); set('X', 2);
    code[(uint8_t)'N'] = NCODE;
    code[(uint8_t)'n'] = NCODE;
  }
};
const Luts LUT;

struct RecordSpan {
  int64_t hdr_start, hdr_end;   // header line [start, end) excl. '\n'/'\r'
  int64_t body_start, body_end; // bytes after header line to next record
};

struct RecOut {
  int64_t code_len = 0;                  // encoded length (newlines removed)
  std::vector<int64_t> segs;             // flattened inclusive [s, e] pairs
  bool keep = false;
};

}  // namespace

extern "C" {

typedef struct {
  uint8_t* codes;
  int64_t* rec_offsets;   // [n_rec + 1]
  char* headers;
  int64_t* hdr_offsets;   // [n_rec + 1]
  int64_t* segs;          // [n_seg * 2]
  int64_t* seg_offsets;   // [n_rec + 1] row offsets into segs
  int64_t n_rec;
  int64_t n_seg;
  int64_t total_len;
  int64_t hdr_len;
  int64_t err_pos;        // byte offset of first invalid nucleotide, -1 = ok
  uint8_t err_char;
} McParseResult;

static void encode_record(const uint8_t* buf, const RecordSpan& rs,
                          uint8_t* out, RecOut* ro,
                          std::atomic<int64_t>* err_pos,
                          std::atomic<uint8_t>* err_char) {
  // copy sequence bytes -> codes, skipping line breaks; find N runs
  int64_t n = 0;
  bool any_n = false;
  for (int64_t p = rs.body_start; p < rs.body_end; ++p) {
    uint8_t b = buf[p];
    if (b == '\n' || b == '\r') continue;
    uint8_t c = LUT.code[b];
    if (c == BAD) {
      int64_t expect = -1;
      err_pos->compare_exchange_strong(expect, p);
      err_char->store(b);
      c = 1;  // keep going so offsets stay consistent; caller aborts
    }
    if (c == NCODE) any_n = true;
    out[n++] = c;
  }
  if (n == 0) { ro->keep = false; return; }
  ro->keep = true;

  // segments
  std::vector<int64_t>& segs = ro->segs;
  if (!any_n) {
    if (n >= MIN_SEG) { segs.push_back(0); segs.push_back(n - 1); }
  } else {
    // maximal non-N runs, merging gaps < MERGE_GAP, dropping runs < MIN_SEG
    int64_t run_start = -1;
    std::vector<int64_t> raw;  // [s, e] pairs
    for (int64_t i = 0; i <= n; ++i) {
      bool is_n = (i == n) || (out[i] == NCODE);
      if (!is_n && run_start < 0) run_start = i;
      if (is_n && run_start >= 0) {
        raw.push_back(run_start);
        raw.push_back(i - 1);
        run_start = -1;
      }
    }
    for (size_t r = 0; r < raw.size(); r += 2) {
      int64_t s = raw[r], e = raw[r + 1];
      if (!segs.empty() && s - segs.back() < MERGE_GAP) {
        segs.back() = e;  // merge into previous
      } else {
        segs.push_back(s);
        segs.push_back(e);
      }
    }
    // drop short, in place
    size_t w = 0;
    for (size_t r = 0; r < segs.size(); r += 2) {
      if (segs[r + 1] - segs[r] + 1 >= MIN_SEG) {
        segs[w] = segs[r];
        segs[w + 1] = segs[r + 1];
        w += 2;
      }
    }
    segs.resize(w);
  }
  // chunk long segments to <= SEG_LENGTH (last fragment absorbs remainder)
  {
    std::vector<int64_t> chunked;
    chunked.reserve(segs.size());
    for (size_t r = 0; r < segs.size(); r += 2) {
      int64_t s = segs[r], e = segs[r + 1], ln = e - s + 1;
      if (ln > SEG_LENGTH) {
        int64_t frag_num = ln / SEG_LENGTH;
        for (int64_t f = 0; f < frag_num; ++f) {
          int64_t fs = s + f * SEG_LENGTH;
          int64_t fe = (f == frag_num - 1) ? e : fs + SEG_LENGTH - 1;
          chunked.push_back(fs);
          chunked.push_back(fe);
        }
      } else {
        chunked.push_back(s);
        chunked.push_back(e);
      }
    }
    segs.swap(chunked);
  }
  // rewrite N markers: inside segments -> code of 'N' (1); outside -> 78
  if (any_n) {
    size_t r = 0;
    int64_t seg_s = segs.empty() ? n : segs[0];
    int64_t seg_e = segs.empty() ? n : segs[1];
    for (int64_t i = 0; i < n; ++i) {
      while (r * 2 < segs.size() && i > seg_e) {
        r += 1;
        if (r * 2 < segs.size()) { seg_s = segs[r * 2]; seg_e = segs[r * 2 + 1]; }
      }
      if (out[i] == NCODE) {
        bool inside = (r * 2 < segs.size()) && i >= seg_s && i <= seg_e;
        out[i] = inside ? 1 : N_BYTE;
      }
    }
  }
  ro->code_len = n;
}

McParseResult* mc_parse_fasta(const char* path, int n_threads) {
  auto* res = (McParseResult*)calloc(1, sizeof(McParseResult));
  res->err_pos = -1;
  FILE* f = fopen(path, "rb");
  if (!f) { res->err_pos = -2; return res; }
  fseek(f, 0, SEEK_END);
  int64_t fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fsize && fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    res->err_pos = -2;
    return res;
  }
  fclose(f);

  // record spans
  std::vector<RecordSpan> recs;
  int64_t i = 0;
  while (i < fsize) {
    // find next '>' at line start
    if (buf[i] == '>') {
      RecordSpan rs;
      rs.hdr_start = i;
      int64_t e = i;
      while (e < fsize && buf[e] != '\n') ++e;
      rs.hdr_end = (e > i && buf[e - 1] == '\r') ? e - 1 : e;
      rs.body_start = (e < fsize) ? e + 1 : fsize;
      // body extends to next header line
      int64_t b = rs.body_start;
      while (b < fsize) {
        if (buf[b] == '>' && (b == 0 || buf[b - 1] == '\n')) break;
        int64_t nl = b;
        while (nl < fsize && buf[nl] != '\n') ++nl;
        b = nl + 1;
      }
      rs.body_end = (b > fsize) ? fsize : b;
      recs.push_back(rs);
      i = rs.body_end;
    } else {
      while (i < fsize && buf[i] != '\n') ++i;  // skip leading junk line
      ++i;
    }
  }

  int64_t n_rec_all = (int64_t)recs.size();
  // phase A: raw body byte counts -> worst-case per-record buffers laid out
  // by prefix sum of body sizes (encoded length <= body bytes)
  std::vector<int64_t> cap_off(n_rec_all + 1, 0);
  for (int64_t r = 0; r < n_rec_all; ++r)
    cap_off[r + 1] = cap_off[r] + (recs[r].body_end - recs[r].body_start);
  std::vector<uint8_t> codes_all(cap_off[n_rec_all]);
  std::vector<RecOut> outs(n_rec_all);

  std::atomic<int64_t> err_pos(-1);
  std::atomic<uint8_t> err_char(0);
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > 32) nt = 32;
  {
    std::vector<std::thread> ths;
    std::atomic<int64_t> next(0);
    for (int t = 0; t < nt; ++t) {
      ths.emplace_back([&]() {
        while (true) {
          int64_t r = next.fetch_add(64);
          if (r >= n_rec_all) break;
          int64_t hi = r + 64 < n_rec_all ? r + 64 : n_rec_all;
          for (; r < hi; ++r)
            encode_record(buf.data(), recs[r], codes_all.data() + cap_off[r],
                          &outs[r], &err_pos, &err_char);
        }
      });
    }
    for (auto& th : ths) th.join();
  }
  if (err_pos.load() >= 0) {
    res->err_pos = err_pos.load();
    res->err_char = err_char.load();
    return res;
  }

  // compact kept records into the result buffers
  int64_t n_rec = 0, total = 0, n_seg = 0, hdr_len = 0;
  for (int64_t r = 0; r < n_rec_all; ++r) {
    if (!outs[r].keep) continue;
    n_rec += 1;
    total += outs[r].code_len;
    n_seg += (int64_t)outs[r].segs.size() / 2;
    hdr_len += recs[r].hdr_end - recs[r].hdr_start;
  }
  res->n_rec = n_rec;
  res->total_len = total;
  res->n_seg = n_seg;
  res->hdr_len = hdr_len;
  res->codes = (uint8_t*)malloc(total ? total : 1);
  res->rec_offsets = (int64_t*)malloc((n_rec + 1) * sizeof(int64_t));
  res->headers = (char*)malloc(hdr_len ? hdr_len : 1);
  res->hdr_offsets = (int64_t*)malloc((n_rec + 1) * sizeof(int64_t));
  res->segs = (int64_t*)malloc((n_seg ? n_seg : 1) * 2 * sizeof(int64_t));
  res->seg_offsets = (int64_t*)malloc((n_rec + 1) * sizeof(int64_t));

  int64_t co = 0, ho = 0, so = 0, k = 0;
  res->rec_offsets[0] = 0;
  res->hdr_offsets[0] = 0;
  res->seg_offsets[0] = 0;
  for (int64_t r = 0; r < n_rec_all; ++r) {
    if (!outs[r].keep) continue;
    memcpy(res->codes + co, codes_all.data() + cap_off[r], outs[r].code_len);
    co += outs[r].code_len;
    int64_t hl = recs[r].hdr_end - recs[r].hdr_start;
    memcpy(res->headers + ho, buf.data() + recs[r].hdr_start, hl);
    ho += hl;
    memcpy(res->segs + so * 2, outs[r].segs.data(),
           outs[r].segs.size() * sizeof(int64_t));
    so += (int64_t)outs[r].segs.size() / 2;
    k += 1;
    res->rec_offsets[k] = co;
    res->hdr_offsets[k] = ho;
    res->seg_offsets[k] = so;
  }
  return res;
}

void mc_free_result(McParseResult* r) {
  if (!r) return;
  free(r->codes);
  free(r->rec_offsets);
  free(r->headers);
  free(r->hdr_offsets);
  free(r->segs);
  free(r->seg_offsets);
  free(r);
}

}  // extern "C"
