// Native gzipped N-Triples parser and term interner: the port's copy of
// the JAX package's native/nt_parser.cc.
//
// Replaces the Python line scanner (rgcn_tpu_torch/data/nt.py) for large
// RDF graphs (AM: ~5.8M triples): streaming gz decode, term scanning,
// string interning and the deterministic sorted-vocabulary remap all
// happen here; Python receives int32 triples plus newline-joined vocab
// blobs.
//
// Term semantics mirror rgcn_tpu_torch/data/nt.py (rdflib's string
// mapping of the reference implementation):
//   <uri>            -> uri without angle brackets
//   _:b0             -> verbatim
//   "lit"@lang / "lit"^^<dt> / "lit" -> verbatim (escapes preserved)
//
// API (ctypes, rgcn_tpu_torch/data/native_nt.py): opaque handle protocol:
// parse once, query sizes, copy out, free.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct NtData {
  std::vector<int32_t> spo;               // (T * 3) interned ids
  std::vector<std::string> node_vocab;    // sorted
  std::vector<std::string> rel_vocab;     // sorted
  std::string error;
};

// Scan one term starting at i; returns term in `out`, advances i past it.
// Returns false on malformed input.
bool scan_term(const std::string& line, size_t& i, std::string& out) {
  const size_t n = line.size();
  while (i < n && (line[i] == ' ' || line[i] == '\t')) ++i;
  if (i >= n) return false;
  const char c = line[i];
  if (c == '<') {
    const size_t j = line.find('>', i);
    if (j == std::string::npos) return false;
    out.assign(line, i + 1, j - i - 1);
    i = j + 1;
    return true;
  }
  if (c == '_') {
    size_t j = i;
    while (j < n && line[j] != ' ' && line[j] != '\t') ++j;
    out.assign(line, i, j - i);
    i = j;
    return true;
  }
  if (c == '"') {
    size_t j = i + 1;
    while (j < n) {
      if (line[j] == '\\') { j += 2; continue; }
      if (line[j] == '"') break;
      ++j;
    }
    if (j >= n) return false;
    ++j;  // past closing quote
    if (j < n && line[j] == '@') {
      while (j < n && line[j] != ' ' && line[j] != '\t') ++j;
    } else if (j + 1 < n && line[j] == '^' && line[j + 1] == '^') {
      j += 2;
      if (j < n && line[j] == '<') {
        const size_t k = line.find('>', j);
        if (k == std::string::npos) return false;
        j = k + 1;
      }
    }
    out.assign(line, i, j - i);
    i = j;
    return true;
  }
  return false;
}

struct Interner {
  std::unordered_map<std::string, int32_t> ids;
  std::vector<std::string> strings;

  int32_t intern(const std::string& s) {
    auto it = ids.find(s);
    if (it != ids.end()) return it->second;
    const int32_t id = static_cast<int32_t>(strings.size());
    ids.emplace(s, id);
    strings.push_back(s);
    return id;
  }
};

// Sort `strings`, return old-id -> new-id remap; `strings` becomes sorted.
std::vector<int32_t> sorted_remap(std::vector<std::string>& strings) {
  const size_t n = strings.size();
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return strings[a] < strings[b];
  });
  std::vector<int32_t> remap(n);
  std::vector<std::string> sorted;
  sorted.reserve(n);
  for (size_t k = 0; k < n; ++k) {
    remap[order[k]] = static_cast<int32_t>(k);
    sorted.push_back(std::move(strings[order[k]]));
  }
  strings = std::move(sorted);
  return remap;
}

}  // namespace

extern "C" {

void* rgcn_nt_parse(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new NtData();
  Interner nodes, rels;

  std::string line;
  std::vector<char> buf(1 << 16);
  std::string s, p, o;
  bool eof = false;
  while (!eof) {
    line.clear();
    // assemble one (possibly long) line
    for (;;) {
      if (gzgets(f, buf.data(), static_cast<int>(buf.size())) == nullptr) {
        eof = true;
        break;
      }
      line += buf.data();
      if (!line.empty() && line.back() == '\n') {
        line.pop_back();
        break;
      }
    }
    if (line.empty()) continue;
    // strip \r and leading whitespace; skip comments
    if (!line.empty() && line.back() == '\r') line.pop_back();
    size_t i = 0;
    while (i < line.size() && (line[i] == ' ' || line[i] == '\t')) ++i;
    if (i >= line.size() || line[i] == '#') continue;
    if (!scan_term(line, i, s) || !scan_term(line, i, p) ||
        !scan_term(line, i, o)) {
      d->error = "malformed N-Triples line: " + line.substr(0, 120);
      gzclose(f);
      return d;  // error reported via rgcn_nt_error
    }
    d->spo.push_back(nodes.intern(s));
    d->spo.push_back(rels.intern(p));
    d->spo.push_back(nodes.intern(o));
  }
  gzclose(f);

  // deterministic ids: sorted vocabulary order (matches the Python loader)
  const auto nmap = sorted_remap(nodes.strings);
  const auto rmap = sorted_remap(rels.strings);
  for (size_t k = 0; k < d->spo.size(); k += 3) {
    d->spo[k + 0] = nmap[d->spo[k + 0]];
    d->spo[k + 1] = rmap[d->spo[k + 1]];
    d->spo[k + 2] = nmap[d->spo[k + 2]];
  }
  d->node_vocab = std::move(nodes.strings);
  d->rel_vocab = std::move(rels.strings);
  return d;
}

const char* rgcn_nt_error(void* h) {
  auto* d = static_cast<NtData*>(h);
  return d->error.empty() ? nullptr : d->error.c_str();
}

int64_t rgcn_nt_num_triples(void* h) {
  return static_cast<NtData*>(h)->spo.size() / 3;
}

int64_t rgcn_nt_num_nodes(void* h) {
  return static_cast<NtData*>(h)->node_vocab.size();
}

int64_t rgcn_nt_num_rels(void* h) {
  return static_cast<NtData*>(h)->rel_vocab.size();
}

// total bytes of the newline-joined vocab blob (which: 0 = nodes, 1 = rels)
int64_t rgcn_nt_vocab_bytes(void* h, int32_t which) {
  auto* d = static_cast<NtData*>(h);
  const auto& v = which == 0 ? d->node_vocab : d->rel_vocab;
  int64_t total = 0;
  for (const auto& s : v) total += static_cast<int64_t>(s.size()) + 1;
  return total;
}

void rgcn_nt_fill(void* h, int32_t* spo_out, char* node_blob,
                  char* rel_blob) {
  auto* d = static_cast<NtData*>(h);
  std::memcpy(spo_out, d->spo.data(), d->spo.size() * sizeof(int32_t));
  char* w = node_blob;
  for (const auto& s : d->node_vocab) {
    std::memcpy(w, s.data(), s.size());
    w += s.size();
    *w++ = '\n';
  }
  w = rel_blob;
  for (const auto& s : d->rel_vocab) {
    std::memcpy(w, s.data(), s.size());
    w += s.size();
    *w++ = '\n';
  }
}

void rgcn_nt_free(void* h) { delete static_cast<NtData*>(h); }

}  // extern "C"
