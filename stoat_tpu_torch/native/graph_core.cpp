// stoat-tpu native core: GFA snarl decomposition.
//
// C++17 port of the Python snarl decomposition
// (stoat_tpu/graph/{gfa,snarls,decompose}.py) — the [native-critical]
// preprocessing stage whose reference counterpart is C++/libbdsg
// (the reference's src/snarl_data_t.cpp:417-773).  Mirrors the Python
// implementation's algorithm exactly (side-based separable-pair snarl
// finding, chain construction with series extension, netgraph path
// enumeration with *-collapse, reference-path positions); the Python
// version remains the readable reference and both are pinned equal by
// parity tests.
//
// C ABI: stoat_decompose_gfa(path, refs, thresholds...) returns the
// snarl_analyse.tsv content and the rejects TSV as malloc'd strings.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC graph_core.cpp -o libstoat_graph.so

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <condition_variable>
#include <map>
#include <mutex>
#include <optional>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <cstdio>

namespace {

static unsigned num_threads() {
    const char* env = getenv("STOAT_THREADS");
    if (env) {
        int v = atoi(env);
        if (v >= 1) return unsigned(v);
    }
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? (hw > 16 ? 16 : hw) : 1;
}

using Handle = uint64_t;  // (node_id << 1) | is_reverse

inline Handle make_handle(uint64_t id, bool rev) { return (id << 1) | uint64_t(rev); }
inline uint64_t node_of(Handle h) { return h >> 1; }
inline bool rev_of(Handle h) { return h & 1; }
inline Handle flip(Handle h) { return h ^ 1; }

struct GPath {
    std::string name;
    std::vector<Handle> steps;
    std::string sample;
    bool is_ref = false;
};

struct Graph {
    std::map<uint64_t, uint32_t> node_len;  // ordered (node_ids() sorted)
    std::unordered_map<Handle, std::vector<Handle>> succ;
    std::vector<GPath> paths;
    // node sequences, kept only when an output needs them (FASTA mode)
    std::unordered_map<uint64_t, std::string> seq;

    // Dense fast index over contiguous-ish node ids (build_index();
    // when absent or a node falls outside it, every accessor falls back
    // to the maps).  The per-query unordered_map/std::map lookups were
    // the find/per-snarl phases' CPU sink at 100k-snarl scale.
    uint64_t fx_min = 0;
    bool fx_ready = false;
    std::vector<int32_t> fx_slot;       // [id - fx_min] -> slot or -1
    std::vector<uint32_t> fx_len;       // slot -> node length
    std::vector<uint32_t> fx_offs;      // vertex (2*slot | orient) CSR
    std::vector<Handle> fx_adj;

    const std::vector<Handle>& successors(Handle h) const {
        static const std::vector<Handle> kEmpty;
        auto it = succ.find(h);
        return it == succ.end() ? kEmpty : it->second;
    }

    inline int64_t fx_slot_of(uint64_t n) const {
        if (n < fx_min) return -1;
        uint64_t k = n - fx_min;
        return k < fx_slot.size() ? fx_slot[size_t(k)] : -1;
    }

    inline uint32_t len_of(uint64_t n) const {
        if (fx_ready) {
            int64_t s = fx_slot_of(n);
            if (s >= 0) return fx_len[size_t(s)];
        }
        auto it = node_len.find(n);
        return it == node_len.end() ? 0 : it->second;
    }

    // successor span: CSR when indexed, map fallback otherwise
    inline std::pair<const Handle*, size_t> succ_span(Handle h) const {
        if (fx_ready) {
            int64_t s = fx_slot_of(node_of(h));
            if (s >= 0) {
                size_t v = 2 * size_t(s) + size_t(h & 1);
                return {fx_adj.data() + fx_offs[v],
                        size_t(fx_offs[v + 1] - fx_offs[v])};
            }
        }
        const auto& vs = successors(h);
        return {vs.data(), vs.size()};
    }

    void build_index() {
        fx_ready = false;
        if (node_len.empty()) return;
        const uint64_t mn = node_len.begin()->first;
        const uint64_t mx = node_len.rbegin()->first;
        if (mx - mn + 1 > 4 * uint64_t(node_len.size()) + 1024)
            return;                      // sparse id space: keep the maps
        fx_min = mn;
        fx_slot.assign(size_t(mx - mn + 1), -1);
        fx_len.resize(node_len.size());
        int32_t s = 0;
        for (const auto& [nid, len] : node_len) {
            fx_slot[size_t(nid - mn)] = s;
            fx_len[size_t(s)] = len;
            ++s;
        }
        const size_t V = 2 * node_len.size();
        fx_offs.assign(V + 1, 0);
        for (const auto& [h, vs] : succ) {
            int64_t sl = fx_slot_of(node_of(h));
            if (sl >= 0)
                fx_offs[2 * size_t(sl) + size_t(h & 1) + 1] =
                    uint32_t(vs.size());
        }
        for (size_t v = 0; v < V; ++v) fx_offs[v + 1] += fx_offs[v];
        fx_adj.resize(fx_offs[V]);
        for (const auto& [h, vs] : succ) {
            int64_t sl = fx_slot_of(node_of(h));
            if (sl < 0) continue;
            size_t base = fx_offs[2 * size_t(sl) + size_t(h & 1)];
            std::copy(vs.begin(), vs.end(), fx_adj.begin() + long(base));
        }
        fx_ready = true;
    }

    void add_succ(Handle u, Handle v) {
        auto& lst = succ[u];
        if (std::find(lst.begin(), lst.end(), v) == lst.end())
            lst.push_back(v);
    }

    void add_edge(Handle a, Handle b) {
        add_succ(a, b);
        add_succ(flip(b), flip(a));
    }
};

// side key of node m exited by handle (m, o) is (m, o); an entry handle
// (m, o) enters through side (m, !o)
inline Handle entry_side(Handle entry) { return flip(entry); }

// ------------------------------------------------------------------
// GFA parsing (S/L/P/W)
// ------------------------------------------------------------------

static std::vector<std::string> split(const std::string& s, char d) {
    std::vector<std::string> out;
    size_t start = 0;
    for (;;) {
        size_t pos = s.find(d, start);
        if (pos == std::string::npos) {
            out.push_back(s.substr(start));
            break;
        }
        out.push_back(s.substr(start, pos - start));
        start = pos + 1;
    }
    return out;
}

static void parse_gfa_path_line(const std::string& line,
                                const std::set<std::string>& ref_names,
                                std::vector<GPath>& out) {
    auto f = split(line, '\t');
    if (f[0] == "P" && f.size() >= 3) {
        GPath p;
        p.name = f[1];
        // PanSN sample#hap#contig
        auto parts = split(f[1], '#');
        p.sample = parts.size() == 3 ? parts[0] : f[1];
        p.is_ref = ref_names.empty() || ref_names.count(f[1]) ||
                   ref_names.count(p.sample);
        // in-place step scan (no per-token substr allocations — the
        // steps field dominates the file at pangenome scale)
        const std::string& sf = f[2];
        p.steps.reserve(size_t(
            std::count(sf.begin(), sf.end(), ',') + 1));
        size_t k = 0;
        while (k < sf.size()) {
            uint64_t id = 0;
            bool any = false;
            while (k < sf.size() && sf[k] >= '0' && sf[k] <= '9') {
                id = id * 10 + uint64_t(sf[k] - '0');
                ++k;
                any = true;
            }
            bool rev = k < sf.size() && sf[k] == '-';
            if (any) p.steps.push_back(make_handle(id, rev));
            while (k < sf.size() && sf[k] != ',') ++k;
            ++k;
        }
        out.push_back(std::move(p));
    } else if (f[0] == "W" && f.size() >= 7) {
        GPath p;
        p.sample = f[1];
        p.name = f[1] + "#" + f[2] + "#" + f[3];
        p.is_ref = ref_names.count(f[1]) > 0;
        const std::string& walk = f[6];
        size_t i = 0;
        while (i < walk.size()) {
            char c = walk[i];
            if (c == '>' || c == '<') {
                bool rev = c == '<';
                size_t j = ++i;
                while (i < walk.size() && isdigit(walk[i])) ++i;
                p.steps.push_back(make_handle(
                    std::stoull(walk.substr(j, i - j)), rev));
            } else {
                ++i;
            }
        }
        out.push_back(std::move(p));
    }
}


static bool load_gfa(const char* path,
                     const std::set<std::string>& ref_names, Graph& g,
                     bool keep_seq = false) {
    // Streaming parse with the P/W path lines handed to a second
    // thread through a BOUNDED queue: at pangenome scale the path-step
    // tokens rival the S/L line count, so the split roughly halves the
    // load wall on a 2-core host (measured) — while memory stays at
    // one line + the queue depth, never the whole file (a multi-GB
    // GFA must not be slurped).
    FILE* fh = fopen(path, "r");
    if (!fh) return false;

    constexpr size_t kQueueCap = 256;
    struct PWLine {
        char* p;
        size_t len;
    };
    std::vector<PWLine> pw_queue;
    std::mutex qmu;
    std::condition_variable qcv_push, qcv_pop;
    bool done = false;
    std::vector<GPath> paths_out;
    std::thread path_thread([&]() {
        std::vector<PWLine> local;
        std::string l;
        for (;;) {
            {
                std::unique_lock<std::mutex> lk(qmu);
                qcv_pop.wait(lk, [&] { return done || !pw_queue.empty(); });
                if (pw_queue.empty() && done) return;
                local.swap(pw_queue);
            }
            qcv_push.notify_one();
            for (const auto& pl : local) {
                l.assign(pl.p, pl.len);
                free(pl.p);
                parse_gfa_path_line(l, ref_names, paths_out);
            }
            local.clear();
        }
    });

    char* lineptr = nullptr;
    size_t cap = 0;
    ssize_t got;
    std::string line;
    while ((got = getline(&lineptr, &cap, fh)) != -1) {
        size_t len = size_t(got);
        while (len && (lineptr[len - 1] == '\n' || lineptr[len - 1] == '\r'))
            --len;
        if (!len) continue;
        char c0 = lineptr[0];
        if (c0 == 'P' || c0 == 'W') {
            // hand the getline buffer itself across (zero copy on this
            // thread); getline mallocs a fresh one next iteration
            PWLine pl{lineptr, len};
            lineptr = nullptr;
            cap = 0;
            std::unique_lock<std::mutex> lk(qmu);
            qcv_push.wait(lk, [&] { return pw_queue.size() < kQueueCap; });
            pw_queue.push_back(pl);
            lk.unlock();
            qcv_pop.notify_one();
            continue;
        }
        if (c0 != 'S' && c0 != 'L') continue;
        line.assign(lineptr, len);
        // S/L dominate line counts at scale: scan them in place instead
        // of allocating per-field substrings
        if (line[0] == 'S' && line[1] == '\t') {
            char* p = nullptr;
            uint64_t id = strtoull(line.c_str() + 2, &p, 10);
            if (p && *p == '\t') {
                const char* seq = p + 1;
                const char* q = strchr(seq, '\t');
                size_t len = q ? size_t(q - seq) : strlen(seq);
                g.node_len[id] = uint32_t(len);
                if (keep_seq) g.seq[id].assign(seq, len);
            }
            continue;
        }
        if (line[0] == 'L' && line[1] == '\t') {
            char* p = nullptr;
            uint64_t aid = strtoull(line.c_str() + 2, &p, 10);
            if (p && p[0] == '\t' && p[1] && p[2] == '\t') {
                bool arev = p[1] == '-';
                char* q = nullptr;
                uint64_t bid = strtoull(p + 3, &q, 10);
                if (q && q[0] == '\t' && q[1]) {
                    g.add_edge(make_handle(aid, arev),
                               make_handle(bid, q[1] == '-'));
                }
            }
            continue;
        }
    }
    free(lineptr);
    fclose(fh);
    {
        std::lock_guard<std::mutex> lk(qmu);
        done = true;
    }
    qcv_pop.notify_one();
    path_thread.join();
    g.paths = std::move(paths_out);
    return true;
}

// ------------------------------------------------------------------
// Snarl finding (mirror of stoat_tpu/graph/snarls.py)
// ------------------------------------------------------------------

struct Snarl {
    Handle start, end;
    std::set<uint64_t> interior;   // ordered for determinism
    int parent = -1;
    std::vector<int> children;
    int depth = 1;
};

struct Forest {
    std::vector<Snarl> snarls;
    std::vector<std::vector<int>> chains;
    std::unordered_map<int, std::vector<int>> chains_by_parent;  // parent (-2 = none/root)
};

constexpr int kMaxExitTries = 64;
constexpr size_t kMaxInterior = 50000;

struct PairResult {
    std::set<uint64_t> interior;
    Handle end_handle;
};

static std::optional<PairResult> test_pair(const Graph& g, Handle a,
                                           uint64_t b_node, size_t budget) {
    uint64_t a_node = node_of(a);
    Handle a_inside = a;  // side key == handle
    if (b_node == a_node) return std::nullopt;

    // scratch reused across the ~2 candidate tests per snarl (the
    // former per-call std::set/std::deque allocations were measurable
    // at 200k candidates); U stays an ordered set only in the returned
    // PairResult
    static thread_local std::unordered_set<uint64_t> U;
    static thread_local std::vector<uint64_t> queue;
    U.clear();
    queue.clear();
    size_t qh = 0;
    std::set<Handle> b_faces;

    {
        auto [sp, sn] = g.succ_span(a);
        for (size_t si = 0; si < sn; ++si) {
            Handle v = sp[si];
            uint64_t m = node_of(v);
            if (m == a_node) {
                if (entry_side(v) != a_inside) return std::nullopt;
                continue;
            }
            if (m == b_node) {
                b_faces.insert(entry_side(v));
                if (b_faces.size() > 1) return std::nullopt;
                continue;
            }
            queue.push_back(m);
        }
    }

    while (qh < queue.size()) {
        uint64_t u = queue[qh++];
        if (U.count(u)) continue;
        U.insert(u);
        if (U.size() > budget || U.size() > kMaxInterior) return std::nullopt;
        for (int o = 0; o < 2; ++o) {
            Handle side = make_handle(u, o);
            auto [sp, sn] = g.succ_span(side);
            for (size_t si = 0; si < sn; ++si) {
                Handle v = sp[si];
                uint64_t m = node_of(v);
                if (m == a_node) {
                    if (entry_side(v) != a_inside) return std::nullopt;
                    continue;
                }
                if (m == b_node) {
                    b_faces.insert(entry_side(v));
                    if (b_faces.size() > 1) return std::nullopt;
                    continue;
                }
                if (!U.count(m)) queue.push_back(m);
            }
        }
    }

    if (b_faces.size() != 1) return std::nullopt;
    Handle b_inside = *b_faces.begin();

    auto ok_inside = [&](Handle side, Handle own_inside, uint64_t other_node,
                         Handle other_inside) {
        auto [sp, sn] = g.succ_span(side);
        for (size_t si = 0; si < sn; ++si) {
            Handle v = sp[si];
            uint64_t m = node_of(v);
            Handle es = entry_side(v);
            if (U.count(m)) continue;
            if (m == node_of(side) && es == own_inside) continue;
            if (m == other_node && es == other_inside) continue;
            return false;
        }
        return true;
    };
    auto ok_outside = [&](Handle side, uint64_t other_node,
                          Handle other_inside) {
        auto [sp, sn] = g.succ_span(side);
        for (size_t si = 0; si < sn; ++si) {
            Handle v = sp[si];
            uint64_t m = node_of(v);
            Handle es = entry_side(v);
            if (U.count(m)) return false;
            if (m == other_node && es == other_inside) return false;
        }
        return true;
    };

    Handle a_outside = flip(a_inside);
    Handle b_outside = flip(b_inside);
    if (!ok_inside(a_inside, a_inside, b_node, b_inside)) return std::nullopt;
    if (!ok_inside(b_inside, b_inside, a_node, a_inside)) return std::nullopt;
    if (!ok_outside(a_outside, b_node, b_inside)) return std::nullopt;
    if (!ok_outside(b_outside, a_node, a_inside)) return std::nullopt;
    if (U.empty() && g.succ_span(a).second < 2) return std::nullopt;

    return PairResult{std::set<uint64_t>(U.begin(), U.end()), b_outside};
}

struct FindResult {
    uint64_t b;
    std::set<uint64_t> interior;
    Handle end_handle;
};

static std::optional<FindResult> find_snarl_from(
        const Graph& g, Handle a, const std::set<uint64_t>& forbidden,
        int max_tries) {
    std::vector<uint64_t> order;
    std::set<uint64_t> seen{node_of(a)};
    {
        auto [sp, sn] = g.succ_span(a);
        for (size_t si = 0; si < sn; ++si) {
            uint64_t m = node_of(sp[si]);
            if (!seen.count(m)) {
                seen.insert(m);
                order.push_back(m);
            }
        }
    }
    int tried = 0;
    size_t qi = 0;
    while (qi < order.size() && tried < max_tries) {
        uint64_t b = order[qi++];
        ++tried;
        auto res = test_pair(g, a, b, 16 * order.size() + 64);
        if (res) {
            bool bad = false;
            for (uint64_t n : res->interior)
                if (forbidden.count(n)) { bad = true; break; }
            if (!bad) return FindResult{b, std::move(res->interior),
                                        res->end_handle};
        }
        for (int o = 0; o < 2; ++o) {
            auto [sp, sn] = g.succ_span(make_handle(b, o));
            for (size_t si = 0; si < sn; ++si) {
                uint64_t m = node_of(sp[si]);
                if (!seen.count(m)) {
                    seen.insert(m);
                    order.push_back(m);
                }
            }
        }
    }
    return std::nullopt;
}

// nodes in nontrivial SCCs of the orientation digraph (or with self
// edges): the only places a single-successor entrance can open a snarl.
// Dense-indexed iterative Tarjan — hash-map bookkeeping per vertex was
// the find-phase hot spot at pangenome scale.
static std::set<uint64_t> cyclic_nodes(const Graph& g) {
    const size_t N = g.node_len.size();
    const size_t V = 2 * N;
    std::set<uint64_t> cyclic;
    if (!N) return cyclic;

    // nodes referenced only by L lines still participate (the hash-map
    // version indexed successor vertices on demand); membership via the
    // O(1) slot table when the CSR index is built (assoc_run always
    // builds it first) — the ordered-map lookups were an O(E log N)
    // sink on pangenome-scale graphs
    auto has_node = [&](uint64_t n) {
        return g.fx_ready ? g.fx_slot_of(n) >= 0
                          : g.node_len.count(n) != 0;
    };
    std::set<uint64_t> extra;
    for (const auto& [u, vs] : g.succ) {
        if (!has_node(node_of(u))) extra.insert(node_of(u));
        for (Handle v : vs)
            if (!has_node(node_of(v))) extra.insert(node_of(v));
    }

    // dense node slots (ids are typically contiguous in GFAs)
    const uint64_t mn = g.node_len.begin()->first;
    const uint64_t mx = g.node_len.rbegin()->first;
    const bool dense = extra.empty() &&
                       (mx - mn + 1) <= 4 * uint64_t(N) + 1024;
    const size_t Vall = V + 2 * extra.size();
    std::vector<int64_t> slot_dense;
    std::unordered_map<uint64_t, int64_t> slot_map;
    std::vector<Handle> vert(Vall);
    {
        int64_t s = 0;
        if (dense) slot_dense.assign(size_t(mx - mn + 1), -1);
        else slot_map.reserve((N + extra.size()) * 2);
        for (const auto& [nid, _len] : g.node_len) {
            if (dense) slot_dense[size_t(nid - mn)] = s;
            else slot_map.emplace(nid, s);
            vert[size_t(2 * s)] = make_handle(nid, false);
            vert[size_t(2 * s + 1)] = make_handle(nid, true);
            ++s;
        }
        for (uint64_t nid : extra) {
            slot_map.emplace(nid, s);
            vert[size_t(2 * s)] = make_handle(nid, false);
            vert[size_t(2 * s + 1)] = make_handle(nid, true);
            ++s;
        }
    }
    auto vid = [&](Handle h) -> int64_t {
        uint64_t n = node_of(h);
        int64_t s;
        if (dense) {
            if (n < mn || n - mn >= slot_dense.size()) return -1;
            s = slot_dense[size_t(n - mn)];
        } else {
            auto it = slot_map.find(n);
            s = it == slot_map.end() ? -1 : it->second;
        }
        return s < 0 ? -1 : 2 * s + int64_t(h & 1);
    };

    std::vector<int32_t> index(Vall, -1), lowlink(Vall, 0);
    std::vector<uint8_t> on_stack(Vall, 0);
    std::vector<uint32_t> stack, comp;
    struct Frame { uint32_t v; uint32_t pos; };
    std::vector<Frame> work;
    int32_t counter = 0;
    for (uint32_t root = 0; root < uint32_t(Vall); ++root) {
        if (index[root] != -1) continue;
        work.push_back({root, 0});
        index[root] = lowlink[root] = counter++;
        stack.push_back(root);
        on_stack[root] = 1;
        while (!work.empty()) {
            uint32_t v = work.back().v;
            auto [sp, sn] = g.succ_span(vert[v]);
            bool advanced = false;
            while (work.back().pos < sn) {
                Handle wh = sp[work.back().pos++];
                int64_t wi = vid(wh);
                if (wi < 0) continue;       // edge to an undeclared node
                uint32_t w = uint32_t(wi);
                if (w == v) {
                    cyclic.insert(node_of(vert[v]));
                } else if (index[w] == -1) {
                    index[w] = lowlink[w] = counter++;
                    stack.push_back(w);
                    on_stack[w] = 1;
                    work.push_back({w, 0});
                    advanced = true;
                    break;
                } else if (on_stack[w]) {
                    lowlink[v] = std::min(lowlink[v], index[w]);
                }
            }
            if (advanced) continue;
            work.pop_back();
            if (!work.empty()) {
                uint32_t parent = work.back().v;
                lowlink[parent] = std::min(lowlink[parent], lowlink[v]);
            }
            if (lowlink[v] == index[v]) {
                comp.clear();
                for (;;) {
                    uint32_t w = stack.back();
                    stack.pop_back();
                    on_stack[w] = 0;
                    comp.push_back(w);
                    if (w == v) break;
                }
                if (comp.size() > 1)
                    for (uint32_t w : comp) cyclic.insert(node_of(vert[w]));
            }
        }
    }
    return cyclic;
}

static Forest find_snarls(const Graph& g) {
    const bool prof = getenv("STOAT_PROFILE") &&
                      !strcmp(getenv("STOAT_PROFILE"), "1");
    auto now = [] {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    };
    double f0 = now();
    // candidates in sorted node order, orientation False then True
    std::set<uint64_t> cyclic = cyclic_nodes(g);
    double f1 = now();
    std::vector<std::pair<Handle, int>> candidates;
    for (const auto& [nid, _len] : g.node_len) {
        for (int o = 0; o < 2; ++o) {
            Handle h = make_handle(nid, o);
            auto [sp, sn] = g.succ_span(h);
            if (sn >= 2) {
                // the true exit of a P-branch bubble appears after P
                // BFS candidates (mirrors snarls.py)
                candidates.push_back(
                    {h, std::max(kMaxExitTries, 2 * int(sn) + 16)});
            } else if (sn == 1) {
                Handle entered = entry_side(sp[0]);
                if (cyclic.count(node_of(sp[0])) &&
                    g.succ_span(entered).second >= 2)
                    candidates.push_back({h, 8});
            }
        }
    }

    // ranks over EVERY reference path (offset per path): stopping at
    // the first left later chromosomes' snarls without reference
    // orientation (mirrors snarls.py)
    std::unordered_map<uint64_t, int> ref_order;
    {
        int base = 0;
        for (const auto& p : g.paths) {
            if (!p.is_ref) continue;
            int rank = 0;
            for (Handle st : p.steps)
                ref_order.emplace(node_of(st), base + rank++);
            base += int(p.steps.size());
        }
        if (ref_order.empty()) {
            for (const auto& p : g.paths) {
                int rank = 0;
                for (Handle st : p.steps)
                    ref_order.emplace(node_of(st), base + rank++);
                base += int(p.steps.size());
            }
        }
    }

    // reference-path termini only (sample paths may end mid-graph)
    std::set<uint64_t> forbidden;
    bool any_ref = false;
    for (const auto& p : g.paths) any_ref = any_ref || p.is_ref;
    for (const auto& p : g.paths) {
        if ((any_ref && !p.is_ref) || p.steps.empty()) continue;
        forbidden.insert(node_of(p.steps.front()));
        forbidden.insert(node_of(p.steps.back()));
    }

    // key = (unordered node pair, interior set)
    struct Chosen { Handle a; Handle end; std::set<uint64_t> U; };
    using CKey = std::tuple<uint64_t, uint64_t, std::vector<uint64_t>>;
    std::map<CKey, Chosen> chosen;
    std::vector<const CKey*> insertion_order;   // map keys are stable
    auto key_of = [](uint64_t x, uint64_t y, const std::set<uint64_t>& U) {
        if (x > y) std::swap(x, y);
        return CKey{x, y, std::vector<uint64_t>(U.begin(), U.end())};
    };
    auto ref_of = [&](uint64_t n) -> std::optional<int> {
        auto it = ref_order.find(n);
        if (it == ref_order.end()) return std::nullopt;
        return it->second;
    };

    // candidate exit searches are independent and read-only on the
    // graph: run them on all cores, then merge in candidate order so
    // the chosen-orientation tie-breaks stay deterministic
    std::vector<std::optional<FindResult>> found(candidates.size());
    {
        std::atomic<size_t> cnext{0};
        auto cworker = [&]() {
            for (;;) {
                size_t i = cnext.fetch_add(1);
                if (i >= candidates.size()) return;
                found[i] = find_snarl_from(g, candidates[i].first,
                                           forbidden,
                                           candidates[i].second);
            }
        };
        unsigned nt = num_threads();
        std::vector<std::thread> pool;
        for (unsigned t = 1; t < nt; ++t) pool.emplace_back(cworker);
        cworker();
        for (auto& th : pool) th.join();
    }
    double f2 = now();
    if (prof)
        fprintf(stderr, "[prof] find: cyclic=%.2fs search=%.2fs (%zu cand)\n",
                f1 - f0, f2 - f1, candidates.size());
    for (size_t ci = 0; ci < candidates.size(); ++ci) {
        Handle a = candidates[ci].first;
        auto& res = found[ci];
        if (!res) continue;
        CKey key = key_of(node_of(a), res->b, res->interior);
        auto it = chosen.find(key);
        if (it != chosen.end()) {
            Handle s0 = it->second.a;
            auto rs = ref_of(node_of(a));
            auto rt = ref_of(res->b);
            auto r0 = ref_of(node_of(s0));
            if (rs && rt && *rs <= *rt &&
                (!r0 || *r0 > *rs || node_of(s0) != node_of(a))) {
                it->second = Chosen{a, res->end_handle, res->interior};
            }
            continue;
        }
        auto ins = chosen.emplace(std::move(key),
                                  Chosen{a, res->end_handle,
                                         std::move(res->interior)});
        insertion_order.push_back(&ins.first->first);
    }

    double f3 = now();
    if (prof)
        fprintf(stderr, "[prof] find: merge=%.2fs (%zu chosen)\n",
                f3 - f2, chosen.size());
    Forest forest;
    for (const CKey* key : insertion_order) {
        auto& c = chosen.at(*key);
        Handle a = c.a, end = c.end;
        auto rs = ref_of(node_of(a));
        auto rt = ref_of(node_of(end));
        if (rs && rt && *rs > *rt) {
            Handle na = flip(end), ne = flip(a);
            a = na;
            end = ne;
        }
        Snarl s;
        s.start = a;
        s.end = end;
        s.interior = c.U;
        forest.snarls.push_back(std::move(s));
    }

    // nesting via node -> containing-snarl index
    std::unordered_map<uint64_t, std::vector<int>> containing;
    for (size_t j = 0; j < forest.snarls.size(); ++j)
        for (uint64_t n : forest.snarls[j].interior)
            containing[n].push_back(int(j));
    // stamp array instead of a per-snarl std::set for the c1 ∩ c2 test
    std::vector<int32_t> stamp(forest.snarls.size(), -1);
    for (size_t i = 0; i < forest.snarls.size(); ++i) {
        Snarl& si = forest.snarls[i];
        const auto* c1 = containing.count(node_of(si.start))
                             ? &containing[node_of(si.start)] : nullptr;
        const auto* c2 = containing.count(node_of(si.end))
                             ? &containing[node_of(si.end)] : nullptr;
        if (!c1 || !c2) continue;
        for (int j : *c1) stamp[size_t(j)] = int32_t(i);
        int best = -1;
        size_t best_size = 0;
        for (int j : *c2) {
            if (j == int(i) || stamp[size_t(j)] != int32_t(i)) continue;
            size_t size = forest.snarls[j].interior.size();
            if (best == -1 || size < best_size ||
                (size == best_size && j < best)) {
                best = j;
                best_size = size;
            }
        }
        if (best >= 0) {
            si.parent = best;
            forest.snarls[best].children.push_back(int(i));
        }
    }
    // depths (iterative)
    for (size_t i = 0; i < forest.snarls.size(); ++i) {
        if (forest.snarls[i].parent != -1) continue;
        std::vector<std::pair<int, int>> stack{{int(i), 1}};
        while (!stack.empty()) {
            auto [j, d] = stack.back();
            stack.pop_back();
            forest.snarls[j].depth = d;
            for (int c : forest.snarls[j].children) stack.push_back({c, d + 1});
        }
    }

    // chains: iterate parents in snarl-index order of first appearance
    std::vector<int> parent_order;
    std::map<int, std::vector<int>> by_parent;
    for (size_t i = 0; i < forest.snarls.size(); ++i) {
        int p = forest.snarls[i].parent;
        if (!by_parent.count(p)) parent_order.push_back(p);
        by_parent[p].push_back(int(i));
    }
    for (int p : parent_order) {
        auto& sibs = by_parent[p];
        std::map<uint64_t, int> by_start, by_end;
        for (int i : sibs) {
            by_start[node_of(forest.snarls[i].start)] = i;
            by_end[node_of(forest.snarls[i].end)] = i;
        }
        std::set<int> used;
        for (int i : sibs) {
            if (used.count(i)) continue;
            std::deque<int> chain{i};
            used.insert(i);
            int cur = i;
            for (;;) {
                auto it = by_start.find(node_of(forest.snarls[cur].end));
                if (it == by_start.end() || used.count(it->second)) break;
                chain.push_back(it->second);
                used.insert(it->second);
                cur = it->second;
            }
            cur = i;
            for (;;) {
                auto it = by_end.find(node_of(forest.snarls[cur].start));
                if (it == by_end.end() || used.count(it->second)) break;
                chain.push_front(it->second);
                used.insert(it->second);
                cur = it->second;
            }
            std::vector<int> cv(chain.begin(), chain.end());
            forest.chains_by_parent[forest.snarls[cv[0]].parent]
                .push_back(int(forest.chains.size()));
            forest.chains.push_back(std::move(cv));
        }
    }
    if (prof)
        fprintf(stderr, "[prof] find: nest+chains=%.2fs\n", now() - f3);
    return forest;
}

// ------------------------------------------------------------------
// Netgraph view + path enumeration (mirror of decompose.py)
// ------------------------------------------------------------------

struct ChainUnit {
    std::vector<int> snarl_ids;
    std::vector<uint64_t> node_ids;
    Handle left, right;
    int n_children = 0;
    bool two_plain() const {
        return snarl_ids.empty() && n_children == 2;
    }
};

struct SnarlReject {
    std::string reason;
};

struct EnumResult {
    std::vector<std::string> pretty;
    std::vector<std::string> types;
    std::vector<std::pair<long, long>> lens;
    bool rejected = false;
    std::string reject_reason;
};

struct Decomposer {
    const Graph& g;
    Forest& forest;
    long cycle_threshold = 1;   // caller's -y/--cycle (mirrors decompose.py)
    std::unordered_map<int, std::pair<long, long>> min_max_cache;

    Decomposer(const Graph& g_, Forest& f_) : g(g_), forest(f_) {}

    std::string handle_str(Handle h) const {
        return (rev_of(h) ? "<" : ">") + std::to_string(node_of(h));
    }

    std::pair<long, long> snarl_min_max(int si);

    EnumResult enumerate_paths(int snarl_idx, long children_threshold,
                               long path_length_threshold,
                               long cycle_threshold);
};

struct NetView {
    std::set<uint64_t> hidden;
    std::vector<ChainUnit> units;
    std::map<Handle, std::pair<int, bool>> chain_entry;  // unit idx, reversed

    NetView(Decomposer& d, int snarl_idx) {
        const Graph& g = d.g;
        Forest& forest = d.forest;
        const Snarl& snarl = forest.snarls[snarl_idx];
        std::set<uint64_t> interior = snarl.interior;
        std::set<uint64_t> bounds{node_of(snarl.start), node_of(snarl.end)};

        std::vector<ChainUnit> base_chains;
        auto it = forest.chains_by_parent.find(snarl_idx);
        if (it != forest.chains_by_parent.end()) {
            for (int cid : it->second) {
                const auto& chain = forest.chains[cid];
                ChainUnit u;
                for (size_t k = 0; k < chain.size(); ++k) {
                    const Snarl& s = forest.snarls[chain[k]];
                    for (uint64_t n : s.interior) hidden.insert(n);
                    hidden.insert(node_of(s.start));
                    hidden.insert(node_of(s.end));
                    if (k == 0) u.node_ids.push_back(node_of(s.start));
                    u.node_ids.push_back(node_of(s.end));
                }
                u.snarl_ids = chain;
                u.left = forest.snarls[chain.front()].start;
                u.right = forest.snarls[chain.back()].end;
                u.n_children = int(chain.size() + u.node_ids.size());
                base_chains.push_back(std::move(u));
            }
        }

        std::set<uint64_t> consumed;
        auto series_next = [&](Handle h) -> std::optional<Handle> {
            const auto& succs = g.successors(h);
            if (succs.size() != 1) return std::nullopt;
            Handle v = succs[0];
            uint64_t m = node_of(v);
            if (bounds.count(m) || !interior.count(m) || hidden.count(m) ||
                consumed.count(m))
                return std::nullopt;
            Handle es = entry_side(v);
            if (g.successors(es).size() != 1) return std::nullopt;
            return v;
        };

        bool changed = true;
        while (changed) {
            changed = false;
            for (auto& unit : base_chains) {
                auto v = series_next(unit.right);
                if (v) {
                    unit.node_ids.push_back(node_of(*v));
                    unit.right = *v;
                    unit.n_children += 1;
                    consumed.insert(node_of(*v));
                    changed = true;
                }
                auto vl = series_next(flip(unit.left));
                if (vl) {
                    unit.node_ids.insert(unit.node_ids.begin(), node_of(*vl));
                    unit.left = flip(*vl);
                    unit.n_children += 1;
                    consumed.insert(node_of(*vl));
                    changed = true;
                }
            }
            bool merged_any = true;
            while (merged_any) {
                merged_any = false;
                for (size_t i1 = 0; i1 < base_chains.size(); ++i1) {
                    auto& u1 = base_chains[i1];
                    const auto& nxts = g.successors(u1.right);
                    if (nxts.size() != 1) continue;
                    for (size_t i2 = 0; i2 < base_chains.size(); ++i2) {
                        if (i1 == i2 || nxts[0] != base_chains[i2].left)
                            continue;
                        Handle es = entry_side(base_chains[i2].left);
                        if (g.successors(es).size() != 1) continue;
                        auto& u2 = base_chains[i2];
                        u1.snarl_ids.insert(u1.snarl_ids.end(),
                                            u2.snarl_ids.begin(),
                                            u2.snarl_ids.end());
                        u1.node_ids.insert(u1.node_ids.end(),
                                           u2.node_ids.begin(),
                                           u2.node_ids.end());
                        u1.right = u2.right;
                        u1.n_children += u2.n_children;
                        base_chains.erase(base_chains.begin() + i2);
                        merged_any = true;
                        changed = true;
                        break;
                    }
                    if (merged_any) break;
                }
            }
        }

        // pure-node chains (sorted plain nodes)
        std::vector<uint64_t> plain;
        for (uint64_t m : interior)
            if (!hidden.count(m) && !consumed.count(m)) plain.push_back(m);
        for (uint64_t m : plain) {
            if (consumed.count(m)) continue;
            for (int o = 0; o < 2; ++o) {
                Handle h = make_handle(m, o);
                if (series_next(flip(h))) continue;  // not a run start
                std::vector<uint64_t> run{m};
                consumed.insert(m);
                Handle cur = h;
                for (;;) {
                    auto v = series_next(cur);
                    if (!v) break;
                    run.push_back(node_of(*v));
                    consumed.insert(node_of(*v));
                    cur = *v;
                }
                if (run.size() >= 2) {
                    ChainUnit u;
                    u.node_ids = run;
                    u.left = h;
                    u.right = cur;
                    u.n_children = int(run.size());
                    base_chains.push_back(std::move(u));
                } else {
                    consumed.erase(m);
                }
                break;
            }
        }

        units = std::move(base_chains);
        for (size_t ui = 0; ui < units.size(); ++ui) {
            chain_entry[units[ui].left] = {int(ui), false};
            chain_entry[flip(units[ui].right)] = {int(ui), true};
            for (uint64_t n : units[ui].node_ids) hidden.insert(n);
        }
    }
};

std::pair<long, long> Decomposer::snarl_min_max(int si) {
    auto it = min_max_cache.find(si);
    if (it != min_max_cache.end()) return it->second;
    auto res = enumerate_paths(si, 1L << 40, 1000000, cycle_threshold);
    std::pair<long, long> out{0, 0};
    if (!res.rejected && !res.lens.empty()) {
        long mn = res.lens[0].first, mx = res.lens[0].second;
        for (auto& l : res.lens) {
            mn = std::min(mn, l.first);
            mx = std::max(mx, l.second);
        }
        out = {mn, mx};
    }
    min_max_cache[si] = out;
    return out;
}

struct PathElem {
    bool is_chain;
    Handle handle;     // node handle, or chain entry handle
    int unit = -1;
    bool rev = false;
    Handle exit = 0;
};

EnumResult Decomposer::enumerate_paths(int snarl_idx, long children_threshold,
                                       long path_length_threshold,
                                       long cycle_threshold) {
    EnumResult out;
    NetView view(*this, snarl_idx);
    const Snarl& snarl = forest.snarls[snarl_idx];
    Handle start = snarl.start, end = snarl.end;
    std::set<uint64_t> allowed = snarl.interior;
    allowed.insert(node_of(start));
    allowed.insert(node_of(end));

    long visible = 0;
    for (uint64_t n : snarl.interior)
        if (!view.hidden.count(n)) ++visible;
    long n_children = visible + long(view.units.size());
    if (n_children > children_threshold) {
        out.rejected = true;
        out.reject_reason = "too_many_children = " +
            std::to_string(n_children) + " children";
        return out;
    }

    std::vector<std::vector<PathElem>> finished;
    std::vector<std::vector<PathElem>> stack;
    stack.push_back({PathElem{false, start}});
    long itr = 0;
    while (!stack.empty()) {
        auto path = std::move(stack.back());
        stack.pop_back();
        // cycle detection
        std::map<std::tuple<bool, uint64_t, bool>, int> occ;
        bool cycle = false;
        for (const auto& el : path) {
            auto key = el.is_chain
                ? std::make_tuple(true, uint64_t(el.unit), el.rev)
                : std::make_tuple(false, el.handle, false);
            if (++occ[key] > cycle_threshold + 1) {
                cycle = true;
                break;
            }
        }
        if (++itr > path_length_threshold) {
            out.rejected = true;
            out.reject_reason = "iteration_calculation_out = " +
                std::to_string(n_children) + " children";
            return out;
        }
        if (cycle) continue;  // over-threshold loops drop entirely
        Handle cur = path.back().is_chain ? path.back().exit
                                          : path.back().handle;
        for (Handle nxt : g.successors(cur)) {
            if (node_of(nxt) == node_of(end) && nxt == end) {
                if (node_of(nxt) != node_of(start) || path.size() > 1) {
                    auto fin = path;
                    fin.push_back(PathElem{false, nxt});
                    finished.push_back(std::move(fin));
                }
                continue;
            }
            if (!allowed.count(node_of(nxt)) ||
                node_of(nxt) == node_of(end) ||
                node_of(nxt) == node_of(start))
                continue;
            auto ce = view.chain_entry.find(nxt);
            if (ce != view.chain_entry.end()) {
                auto [ui, rv] = ce->second;
                const ChainUnit& u = view.units[ui];
                PathElem el;
                el.is_chain = true;
                el.unit = ui;
                el.rev = rv;
                if (!rv) {
                    el.handle = u.left;
                    el.exit = u.right;
                } else {
                    el.handle = flip(u.right);
                    el.exit = flip(u.left);
                }
                auto np = path;
                np.push_back(el);
                stack.push_back(std::move(np));
            } else if (view.hidden.count(node_of(nxt))) {
                continue;
            } else {
                auto np = path;
                np.push_back(PathElem{false, nxt});
                stack.push_back(std::move(np));
            }
        }
    }

    // render
    struct Rendered {
        std::vector<Handle> walk;
        std::string str;
        long mn, mx;
        int n_parts;
    };
    std::vector<Rendered> rendered;
    for (const auto& path : finished) {
        Rendered r;
        r.mn = r.mx = 0;
        long inner = 0;
        for (size_t i = 0; i < path.size(); ++i) {
            const auto& el = path[i];
            if (!el.is_chain) {
                r.walk.push_back(el.handle);
                if (i > 0 && i + 1 < path.size())
                    inner += g.node_len.at(node_of(el.handle));
            } else {
                const ChainUnit& u = view.units[el.unit];
                long cmn = 0, cmx = 0;
                for (int si : u.snarl_ids) {
                    auto [a, b] = snarl_min_max(si);
                    cmn += a;
                    cmx += b;
                }
                for (uint64_t n : u.node_ids) {
                    cmn += g.node_len.at(n);
                    cmx += g.node_len.at(n);
                }
                r.walk.push_back(el.handle);
                if (!u.two_plain()) {
                    r.walk.push_back(make_handle(0, false));
                } else {
                    // reference double-counts 2-node chains (see the
                    // Python twin); pinned by its loop_double unit test
                    r.mn += cmn;
                    r.mx += cmx;
                }
                r.walk.push_back(el.exit);
                r.mn += cmn;
                r.mx += cmx;
            }
        }
        r.mn += inner;
        r.mx += inner;
        r.n_parts = int(r.walk.size());
        std::string s;
        for (Handle h : r.walk) s += handle_str(h);
        r.str = std::move(s);
        rendered.push_back(std::move(r));
    }

    // deterministic order: by walk [(id, rev)...] then string
    std::sort(rendered.begin(), rendered.end(),
              [](const Rendered& x, const Rendered& y) {
                  if (x.walk != y.walk) return x.walk < y.walk;
                  return x.str < y.str;
              });

    for (const auto& r : rendered) {
        out.pretty.push_back(r.str);
        out.lens.push_back({r.mn, r.mx});
        if (r.n_parts >= 3) {
            out.types.push_back(
                r.mn != r.mx ? std::to_string(r.mn) + "/" + std::to_string(r.mx)
                             : std::to_string(r.mn));
        } else if (r.n_parts == 2) {
            out.types.push_back("0");
        } else {
            out.types.push_back("NA");
        }
    }
    return out;
}

// ------------------------------------------------------------------
// Full decomposition to TSV (mirror of decompose_graph)
// ------------------------------------------------------------------

struct DecomposeOutput {
    std::string tsv;
    std::string rejects;
    bool ok = true;
    std::string error;
};

static DecomposeOutput decompose(const Graph& g,
                                 const std::set<std::string>& ref_chr,
                                 long children_threshold,
                                 long path_length_threshold,
                                 long cycle_threshold) {
    DecomposeOutput out;
    Graph& gm = const_cast<Graph&>(g);
    gm.build_index();    // CSR adjacency for the snarl-finding hot loops
    Forest forest = find_snarls(g);
    Decomposer d(g, forest);
    d.cycle_threshold = cycle_threshold;

    // reference offsets per ref path (first visit)
    std::vector<std::pair<std::string, std::unordered_map<uint64_t, long>>>
        ref_offsets;
    for (const auto& p : g.paths) {
        bool candidate = ref_chr.empty()
            ? p.is_ref
            : (ref_chr.count(p.name) || ref_chr.count(p.sample));
        if (!candidate) continue;
        std::unordered_map<uint64_t, long> offs;
        long pos = 0;
        for (Handle st : p.steps) {
            offs.emplace(node_of(st), pos);
            pos += g.node_len.at(node_of(st));
        }
        ref_offsets.push_back({p.name, std::move(offs)});
    }

    auto node_position = [&](uint64_t nid)
        -> std::optional<std::tuple<std::string, long, long>> {
        for (const auto& [chrom, offs] : ref_offsets) {
            auto it = offs.find(nid);
            if (it != offs.end()) {
                long pos = it->second;
                return std::make_tuple(chrom, pos + long(g.node_len.at(nid)),
                                       pos + 1);
            }
        }
        return std::nullopt;
    };

    // group BY CHROMOSOME then position (mirrors decompose.py: an
    // interleaved TSV loses snarls through parse_snarl_path's
    // last-block-per-chromosome reference-parity quirk)
    auto sort_key = [&](int i) -> std::tuple<int, std::string, long> {
        auto p = node_position(node_of(forest.snarls[i].start));
        if (!p) return {1, std::string(), 1L << 60};
        return {0, std::get<0>(*p), std::get<1>(*p)};
    };

    // resolve positions with parent inheritance (memoized)
    std::unordered_map<int, std::tuple<std::string, long, long, bool>> positions;
    std::function<std::tuple<std::string, long, long, bool>(int)> resolve =
        [&](int i) -> std::tuple<std::string, long, long, bool> {
        auto it = positions.find(i);
        if (it != positions.end()) return it->second;
        const Snarl& s = forest.snarls[i];
        auto p1 = node_position(node_of(s.end));
        auto p2 = node_position(node_of(s.start));
        std::tuple<std::string, long, long, bool> res;
        if (!p1 && !p2) {
            if (s.parent != -1) {
                auto [chrom, a, b, _r] = resolve(s.parent);
                res = {chrom, a, b, false};
            } else {
                res = {"", 0, 0, false};
            }
        } else if (!p1 || !p2) {
            // one bound off-reference: order the single known pair
            // (mirrors decompose.py; raw order printed inverted
            // START_POS > END_POS intervals)
            auto& p = p1 ? p1 : p2;
            long a = std::get<1>(*p), b = std::get<2>(*p);
            res = {std::get<0>(*p), std::min(a, b), std::max(a, b),
                   true};
        } else {
            if (std::get<1>(*p1) < std::get<1>(*p2))
                res = {std::get<0>(*p1), std::get<1>(*p1), std::get<2>(*p2),
                       true};
            else
                res = {std::get<0>(*p1), std::get<1>(*p2), std::get<2>(*p1),
                       true};
        }
        positions[i] = res;
        return res;
    };

    // tree order: top-level sorted by ref position (stable), DFS pre-order
    std::vector<int> order;
    std::function<void(int)> visit = [&](int i) {
        order.push_back(i);
        std::vector<int> kids = forest.snarls[i].children;
        std::stable_sort(kids.begin(), kids.end(), [&](int x, int y) {
            return sort_key(x) < sort_key(y);
        });
        for (int c : kids) visit(c);
    };
    std::vector<int> tops;
    for (size_t i = 0; i < forest.snarls.size(); ++i)
        if (forest.snarls[i].parent == -1) tops.push_back(int(i));
    std::stable_sort(tops.begin(), tops.end(), [&](int x, int y) {
        return sort_key(x) < sort_key(y);
    });
    for (int i : tops) visit(i);

    std::ostringstream tsv, rej;
    tsv << "CHR\tSTART_POS\tEND_POS\tSNARL_HANDLEGRAPH\tSNARL\tPATHS\tTYPE\t"
           "REF\tDEPTH\n";
    rej << "SNARL\tREASON\n";

    // Per-snarl path enumeration is embarrassingly parallel (the
    // reference's `#pragma omp parallel for` over snarls,
    // snarl_data_t.cpp:667); enumerate into per-index results with
    // per-thread Decomposers (each owns its min/max cache; Graph and
    // Forest are read-only here), then write serially in tree order so
    // output is byte-identical for any thread count.
    std::vector<EnumResult> results(order.size());
    const unsigned nt = num_threads();
    if (nt > 1 && order.size() > 8) {
        std::atomic<size_t> next{0};
        auto work = [&] {
            Decomposer dl(g, forest);
            dl.cycle_threshold = cycle_threshold;
            size_t k;
            while ((k = next.fetch_add(1)) < order.size())
                results[k] = dl.enumerate_paths(
                    order[k], children_threshold, path_length_threshold,
                    cycle_threshold);
        };
        std::vector<std::thread> threads;
        for (unsigned t = 1; t < nt; ++t) threads.emplace_back(work);
        work();
        for (auto& th : threads) th.join();
    } else {
        for (size_t k = 0; k < order.size(); ++k)
            results[k] = d.enumerate_paths(order[k], children_threshold,
                                           path_length_threshold,
                                           cycle_threshold);
    }

    long n_paths_total = 0;
    for (size_t k = 0; k < order.size(); ++k) {
        int i = order[k];
        const Snarl& s = forest.snarls[i];
        std::string sid = std::to_string(node_of(s.start)) + "_" +
                          std::to_string(node_of(s.end));
        EnumResult& res = results[k];
        if (res.rejected) {
            rej << sid << "\t" << res.reject_reason << "\n";
            continue;
        }
        if (res.pretty.size() < 2) continue;
        auto [chrom, start_pos, end_pos1, on_ref] = resolve(i);
        if (chrom.empty()) continue;
        tsv << chrom << "\t" << start_pos << "\t" << (end_pos1 - 1) << "\t"
            << i << "\t" << sid << "\t";
        for (size_t k = 0; k < res.pretty.size(); ++k) {
            if (k) tsv << ",";
            tsv << res.pretty[k];
        }
        tsv << "\t";
        for (size_t k = 0; k < res.types.size(); ++k) {
            if (k) tsv << ",";
            tsv << res.types[k];
        }
        tsv << "\t" << (on_ref ? "1" : "0") << "\t" << s.depth << "\n";
        n_paths_total += long(res.pretty.size());
    }

    if (n_paths_total == 0) {
        out.ok = false;
        out.error = "Total number of paths = 0";
        return out;
    }
    out.tsv = tsv.str();
    out.rejects = rej.str();
    (void)gm;
    return out;
}

}  // namespace

// ------------------------------------------------------------------
// Graph-mode association prepare (the `stoat graph` native fast path).
//
// Everything up to the statistical tests runs here in one call: GFA
// load, snarl finding, per-snarl min/max allele length + regularity,
// walk-set sample partitioning (PathPartitioner::get_walk_sets,
// the reference's src/partitioner.cpp:36-268 — start-bound refinement
// plus per-child refinement for irregular snarls), reference-path
// coordinates, and the conditional tree walk of
// AssociationFinder::test_snarls (the reference's src/
// graph_path_association_finder.cpp:29-199).  Python gets back
// ready-to-write row text plus flat per-partition case/control counts
// for the batched device chi²/Fisher kernels.  Semantics mirror the
// Python twin in stoat_tpu/graph/association.py line for line (pinned
// by the graph-contract tests).
// ------------------------------------------------------------------

static void assoc_min_max_len(const Graph& g, const Snarl& s,
                              long* mn_out, long* mx_out) {
    // mirror of association.py _snarl_min_max_len: min/max interior
    // sequence length over simple start->end traversals, LIFO stack,
    // budget 200000 pops.  Interiors of <= 64 nodes (virtually every
    // snarl) carry the visited set as one uint64 bitmask — the former
    // per-item std::set copies were the per-snarl hot spot (malloc
    // churn at 100k-snarl scale, measured).
    long best_min = -1, best_max = -1;
    const uint64_t end_node = node_of(s.end);
    const size_t ni_count = s.interior.size();
    if (ni_count <= 64) {
        std::vector<uint64_t> ids(s.interior.begin(), s.interior.end());
        auto bit = [&](uint64_t m) -> int {
            size_t lo = 0, hi = ids.size();
            while (lo < hi) {
                size_t mid = (lo + hi) / 2;
                if (ids[mid] < m) lo = mid + 1; else hi = mid;
            }
            return (lo < ids.size() && ids[lo] == m) ? int(lo) : -1;
        };
        struct Item {
            Handle h;
            uint64_t visited;
            long total;
        };
        std::vector<Item> stack;
        stack.push_back({s.start, 0, 0});
        long budget = 200000;
        while (!stack.empty() && budget > 0) {
            --budget;
            Item it = stack.back();
            stack.pop_back();
            auto [sp, sn] = g.succ_span(it.h);
            for (size_t si = 0; si < sn; ++si) {
                Handle v = sp[si];
                uint64_t m = node_of(v);
                if (m == end_node) {
                    if (best_min < 0 || it.total < best_min)
                        best_min = it.total;
                    if (it.total > best_max) best_max = it.total;
                    continue;
                }
                int b = bit(m);
                if (b < 0 || (it.visited >> b) & 1) continue;
                stack.push_back({v, it.visited | (uint64_t(1) << b),
                                 it.total + long(g.len_of(m))});
            }
        }
    } else {
        struct Item {
            Handle h;
            std::set<uint64_t> visited;
            long total;
        };
        std::vector<Item> stack;
        stack.push_back({s.start, {}, 0});
        long budget = 200000;
        while (!stack.empty() && budget > 0) {
            --budget;
            Item it = std::move(stack.back());
            stack.pop_back();
            auto [sp, sn] = g.succ_span(it.h);
            for (size_t si = 0; si < sn; ++si) {
                Handle v = sp[si];
                uint64_t m = node_of(v);
                if (m == end_node) {
                    if (best_min < 0 || it.total < best_min)
                        best_min = it.total;
                    if (it.total > best_max) best_max = it.total;
                } else if (s.interior.count(m) && !it.visited.count(m)) {
                    Item ni;
                    ni.h = v;
                    ni.visited = it.visited;
                    ni.visited.insert(m);
                    ni.total = it.total + long(g.len_of(m));
                    stack.push_back(std::move(ni));
                }
            }
        }
    }
    if (best_min < 0) {
        *mn_out = 0;
        *mx_out = 0;
    } else {
        *mn_out = best_min;
        *mx_out = best_max;
    }
}

static bool assoc_is_regular(const Graph& g, const Snarl& s) {
    // mirror of association.py _is_regular_snarl
    if (!s.children.empty()) return false;
    const uint64_t sn = node_of(s.start), en = node_of(s.end);
    for (uint64_t nid : s.interior) {
        for (int o = 0; o < 2; ++o) {
            auto [sp, snc] = g.succ_span(make_handle(nid, o));
            for (size_t si = 0; si < snc; ++si) {
                uint64_t m = node_of(sp[si]);
                if (s.interior.count(m)) return false;   // child-child edge
                if (m != sn && m != en) return false;    // leaves the snarl
            }
        }
    }
    const Handle bounds[2] = {s.start, flip(s.end)};
    for (Handle h : bounds) {
        auto [sp, snc] = g.succ_span(h);
        for (size_t si = 0; si < snc; ++si)
            if (node_of(sp[si]) == node_of(h)) return false;  // reversal
    }
    return true;
}

static std::vector<Handle> assoc_child_handles(const Forest& f, int si) {
    // mirror of association.py PathPartitioner._child_handles
    const Snarl& s = f.snarls[size_t(si)];
    std::set<uint64_t> hidden;
    std::vector<Handle> chain_handles;
    auto it = f.chains_by_parent.find(si);
    if (it != f.chains_by_parent.end()) {
        for (int ci : it->second) {
            const auto& chain = f.chains[size_t(ci)];
            const Snarl& first = f.snarls[size_t(chain.front())];
            const Snarl& last = f.snarls[size_t(chain.back())];
            for (int sj : chain) {
                const Snarl& sc = f.snarls[size_t(sj)];
                hidden.insert(sc.interior.begin(), sc.interior.end());
                hidden.insert(node_of(sc.start));
                hidden.insert(node_of(sc.end));
            }
            chain_handles.push_back(last.end);          // rightward
            chain_handles.push_back(flip(first.start)); // leftward
        }
    }
    std::vector<Handle> handles;
    for (uint64_t nid : s.interior) {                   // std::set: sorted
        if (hidden.count(nid)) continue;
        handles.push_back(make_handle(nid, false));
        handles.push_back(make_handle(nid, true));
    }
    for (Handle h : chain_handles) handles.push_back(h);
    return handles;
}

struct AssocIndex {
    // wanted (phenotype-matched) paths in g.paths order
    std::vector<const std::vector<Handle>*> steps;
    std::vector<int32_t> path_sample;   // pheno sample id per path

    // node -> (path, step) entries as CSR over dense node slots; a
    // per-node vector map at pangenome scale (10M+ steps) is allocation-
    // bound — the CSR build is two linear passes
    uint64_t min_id = 0;
    bool dense = false;
    std::vector<int64_t> slot_dense;                  // id-min_id -> slot
    std::unordered_map<uint64_t, int64_t> slot_map;   // sparse fallback
    std::vector<uint64_t> ns_offs;
    std::vector<std::pair<int32_t, int32_t>> ns_entries;

    int64_t slot(uint64_t node) const {
        if (dense) {
            if (node < min_id || node - min_id >= slot_dense.size())
                return -1;
            return slot_dense[node - min_id];
        }
        auto it = slot_map.find(node);
        return it == slot_map.end() ? -1 : it->second;
    }

    void build(const Graph& g) {
        const size_t N = g.node_len.size();
        if (N) {
            const uint64_t mn = g.node_len.begin()->first;
            const uint64_t mx = g.node_len.rbegin()->first;
            min_id = mn;
            dense = (mx - mn + 1) <= 4 * uint64_t(N) + 1024;
            int64_t s = 0;
            if (dense) {
                slot_dense.assign(size_t(mx - mn + 1), -1);
                for (const auto& [nid, _len] : g.node_len)
                    slot_dense[size_t(nid - mn)] = s++;
            } else {
                slot_map.reserve(N * 2);
                for (const auto& [nid, _len] : g.node_len)
                    slot_map.emplace(nid, s++);
            }
        }
        std::vector<uint32_t> counts(N, 0);
        uint64_t total = 0;
        for (const auto* sp : steps) {
            total += sp->size();
            for (Handle st : *sp) {
                int64_t s = slot(node_of(st));
                if (s >= 0) ++counts[size_t(s)];
            }
        }
        ns_offs.assign(N + 1, 0);
        for (size_t i = 0; i < N; ++i)
            ns_offs[i + 1] = ns_offs[i] + counts[i];
        ns_entries.resize(size_t(ns_offs[N]));
        std::vector<uint64_t> cur(ns_offs.begin(), ns_offs.end() - 1);
        for (size_t p = 0; p < steps.size(); ++p) {
            const auto& sv = *steps[p];
            for (size_t si = 0; si < sv.size(); ++si) {
                int64_t s = slot(node_of(sv[si]));
                if (s >= 0)
                    ns_entries[size_t(cur[size_t(s)]++)] = {int32_t(p),
                                                            int32_t(si)};
            }
        }
    }
};

static void assoc_refine(const AssocIndex& ix, Handle handle,
                         std::vector<int32_t>& old_sets, int32_t& set_count,
                         std::vector<std::vector<std::pair<int32_t, Handle>>>&
                             per_path,
                         std::vector<int32_t>& touched,
                         std::vector<int32_t>& inter_sets) {
    // mirror of PathPartitioner.partition_samples_in_snarl's refine():
    // per-path ordered outgoing-edge tuples at `handle`, intermediate
    // ids by first appearance in path order, then (old, inter) -> new
    // renumbering over ALL paths with (0,0) pinned to 0
    const size_t n = old_sets.size();
    touched.clear();
    const int64_t slot = ix.slot(node_of(handle));
    if (slot >= 0) {
        const uint64_t orient = handle & 1;
        for (uint64_t e = ix.ns_offs[size_t(slot)];
             e < ix.ns_offs[size_t(slot) + 1]; ++e) {
            int32_t p = ix.ns_entries[size_t(e)].first;
            int32_t si = ix.ns_entries[size_t(e)].second;
            const auto& steps = *ix.steps[size_t(p)];
            bool fwd = (steps[size_t(si)] & 1) == orient;
            int64_t j = fwd ? si + 1 : si - 1;
            if (j < 0 || j >= int64_t(steps.size())) continue;
            if (per_path[size_t(p)].empty()) touched.push_back(p);
            per_path[size_t(p)].push_back({si, steps[size_t(j)]});
        }
        std::sort(touched.begin(), touched.end());
    }
    std::fill(inter_sets.begin(), inter_sets.end(), 0);
    std::map<std::vector<Handle>, int32_t> inter_map;
    int32_t next_inter = 1;
    std::vector<Handle> key;
    for (int32_t p : touched) {
        auto& cr = per_path[size_t(p)];
        std::sort(cr.begin(), cr.end());
        key.clear();
        for (const auto& e : cr) key.push_back(e.second);
        auto ins = inter_map.emplace(key, next_inter);
        if (ins.second) ++next_inter;
        inter_sets[size_t(p)] = ins.first->second;
        cr.clear();
    }
    std::map<std::pair<int32_t, int32_t>, int32_t> mapping;
    mapping[{0, 0}] = 0;
    int32_t new_count = 1;
    for (size_t i = 0; i < n; ++i) {
        auto ins = mapping.emplace(
            std::make_pair(old_sets[i], inter_sets[i]), new_count);
        if (ins.second) ++new_count;
        old_sets[i] = ins.first->second;
    }
    set_count = new_count;
}

extern "C" {

// returns 0 on success; caller frees *tsv_out and *rejects_out with
// stoat_free_str
int stoat_decompose_gfa(const char* gfa_path, const char* ref_names_csv,
                        long children_threshold, long path_length_threshold,
                        long cycle_threshold, char** tsv_out,
                        char** rejects_out, char** error_out) {
    std::set<std::string> refs;
    if (ref_names_csv && *ref_names_csv) {
        std::string csv = ref_names_csv;
        size_t start = 0;
        for (;;) {
            size_t pos = csv.find(',', start);
            std::string tok = csv.substr(
                start, pos == std::string::npos ? std::string::npos
                                                : pos - start);
            if (!tok.empty()) refs.insert(tok);
            if (pos == std::string::npos) break;
            start = pos + 1;
        }
    }
    Graph g;
    if (!load_gfa(gfa_path, refs, g)) {
        *error_out = strdup("could not open GFA");
        return 1;
    }
    auto res = decompose(g, refs, children_threshold, path_length_threshold,
                         cycle_threshold);
    if (!res.ok) {
        *error_out = strdup(res.error.c_str());
        return 2;
    }
    *tsv_out = strdup(res.tsv.c_str());
    *rejects_out = strdup(res.rejects.c_str());
    return 0;
}

// Decompose a graph handed over as flat arrays — the natively-loaded
// binary formats (.hg/.pg/.gbz readers in Python) feed the C++ core
// directly instead of round-tripping through a temporary GFA file.
//
//   node_ids/node_lens: [N] parallel arrays
//   succ_pairs:         [n_succ, 2] packed handles ((id<<1)|rev) — the
//                       EXACT successor lists of the loaded graph, in
//                       order (edge symmetry already materialized), so
//                       enumeration order matches the Python twin
//   steps:              [T] packed handles, concatenated per path
//   path_offsets:       [P+1]
//   names/samples:      '\0'-joined blobs, P entries each
//   is_ref:             [P]
int stoat_decompose_arrays(
        const uint64_t* node_ids, const uint32_t* node_lens,
        uint64_t n_nodes, const uint64_t* succ_pairs, uint64_t n_succ,
        const uint64_t* steps, const uint64_t* path_offsets,
        uint64_t n_paths, const char* names_blob, const char* samples_blob,
        const uint8_t* is_ref, long children_threshold,
        long path_length_threshold, long cycle_threshold, char** tsv_out,
        char** rejects_out, char** error_out) {
    Graph g;
    for (uint64_t i = 0; i < n_nodes; ++i)
        g.node_len[node_ids[i]] = node_lens[i];
    for (uint64_t i = 0; i < n_succ; ++i)
        g.succ[succ_pairs[2 * i]].push_back(succ_pairs[2 * i + 1]);
    const char* name_p = names_blob;
    const char* sample_p = samples_blob;
    for (uint64_t p = 0; p < n_paths; ++p) {
        GPath gp;
        gp.name = name_p;
        name_p += gp.name.size() + 1;
        gp.sample = sample_p;
        sample_p += gp.sample.size() + 1;
        gp.is_ref = is_ref[p] != 0;
        for (uint64_t t = path_offsets[p]; t < path_offsets[p + 1]; ++t)
            gp.steps.push_back(steps[t]);
        g.paths.push_back(std::move(gp));
    }
    std::set<std::string> refs;  // is_ref is already resolved per path
    auto res = decompose(g, refs, children_threshold,
                         path_length_threshold, cycle_threshold);
    if (!res.ok) {
        *error_out = strdup(res.error.c_str());
        return 2;
    }
    *tsv_out = strdup(res.tsv.c_str());
    *rejects_out = strdup(res.rejects.c_str());
    return 0;
}

void stoat_free_str(char* s) { free(s); }

// Final TSV text for graph-mode rows: splices the device-computed
// P_FISHER/P_CHI2 into the kind-1 payloads of stoat_graph_assoc.
// Twin of stoat::set_precision (utils.cpp:5-15), identical to
// stoat_core.cpp's fmt_p (pinned by the formatting tests).
// p22/pf/pn/is_two are indexed by tested (kind-1) row order.
// Returns a malloc'd blob (caller frees); length in *out_len.
char* stoat_graph_format_rows(
        const char* rows_blob, uint64_t rows_len, const uint8_t* kinds,
        long n_rows, const double* p22, const double* pf,
        const double* pn, const uint8_t* is_two, uint64_t* out_len) {
    auto fmt_p = [](double v, std::string& out) {
        char buf[48];
        if (v != v) { out += "NA"; return; }
        if (v == HUGE_VAL) { out += "inf"; return; }
        if (v == -HUGE_VAL) { out += "-inf"; return; }
        if (v != 0.0 && v < 0.1 && v > -0.1)
            snprintf(buf, sizeof buf, "%.4e", v);
        else
            snprintf(buf, sizeof buf, "%.4g", v);
        out += buf;
    };
    std::string out;
    out.reserve(rows_len + size_t(n_rows) * 24);
    const char* p = rows_blob;
    const char* end = rows_blob + rows_len;
    long ti = 0;
    for (long i = 0; i < n_rows && p < end; ++i) {
        const char* z = (const char*)memchr(p, '\0', size_t(end - p));
        if (!z) z = end;
        if (kinds[i] == 0) {
            out.append(p, size_t(z - p));
            out += '\n';
        } else {
            const char* sep = (const char*)memchr(p, '\x01',
                                                  size_t(z - p));
            if (!sep) sep = z;
            out.append(p, size_t(sep - p));         // prefix
            out += '\t';
            if (is_two[ti]) fmt_p(pf[ti], out); else out += "NA";
            out += '\t';
            fmt_p(is_two[ti] ? p22[ti] : pn[ti], out);
            out += '\t';
            if (sep < z) out.append(sep + 1, size_t(z - sep - 1));
            out += '\n';
            ++ti;
        }
        p = z + 1;
    }
    char* buf = (char*)malloc(out.size() + 1);
    if (!buf) { *out_len = 0; return nullptr; }
    memcpy(buf, out.data(), out.size());
    buf[out.size()] = '\0';
    *out_len = out.size();
    return buf;
}


// ---------------------------------------------------------------------------
// Graph-mode walk-set partitioning (production native core).
//
// The per-snarl sample partitioning of PathPartitioner::get_walk_sets
// (the reference's src/partitioner.cpp:36-268) for REGULAR snarls: refine
// sample paths by the ordered tuple of outgoing edges each path takes
// from the snarl's start bound.  Runs parallel over snarls with a shared
// node->steps index; group order preserves first appearance by path
// index (the Python partitioner's set-id order, so GROUP_PATHS columns
// match byte-for-byte).
//
// Outputs (malloc'd, caller frees with stoat_free_str/free):
//   part_offs u64[n_snarls+1]  — partition ranges per snarl
//   n_case    u32[total_parts] — distinct case samples per partition
//   n_ctrl    u32[total_parts] — distinct control samples per partition
//   rep       i32[total_parts] — smallest sample id in the partition
//                                (callers order ids lexicographically)
// Returns total partition count, or -1.
long stoat_graph_partitions(
        const uint64_t* steps, const int64_t* offsets, long n_paths,
        const int32_t* path_sample, long n_samples,
        const uint64_t* start_handles, long n_snarls,
        const uint8_t* sample_case, long threads,
        uint64_t** part_offs_out, uint32_t** case_out,
        uint32_t** ctrl_out, int32_t** rep_out) {
    // node id -> [(path, step)] index, like handlegraph's step index
    std::unordered_map<uint64_t,
                       std::vector<std::pair<int32_t, int32_t>>> node_steps;
    for (long p = 0; p < n_paths; ++p)
        for (int64_t i = offsets[p]; i < offsets[p + 1]; ++i)
            node_steps[steps[i] >> 1].push_back(
                {int32_t(p), int32_t(i - offsets[p])});

    struct SnarlParts {
        std::vector<uint32_t> n_case, n_ctrl;
        std::vector<int32_t> rep;
    };
    std::vector<SnarlParts> results((size_t(n_snarls)));

    unsigned nt = threads >= 1 ? unsigned(threads) : num_threads();
    if (nt < 1) nt = 1;
    std::atomic<long> next{0};
    auto worker = [&]() {
        // per-thread scratch
        std::vector<std::vector<std::pair<int32_t, uint64_t>>> per_path;
        std::vector<int32_t> touched;
        std::map<std::vector<uint64_t>, int32_t> group_of;
        for (;;) {
            long s = next.fetch_add(1);
            if (s >= n_snarls) return;
            uint64_t h = start_handles[s];
            auto it = node_steps.find(h >> 1);
            if (it == node_steps.end()) continue;
            uint64_t orient = h & 1;

            if (per_path.size() < size_t(n_paths))
                per_path.resize(size_t(n_paths));
            touched.clear();
            for (const auto& ps : it->second) {
                int32_t p = ps.first, si = ps.second;
                int64_t base = offsets[p];
                uint64_t st = steps[base + si];
                bool go_fwd = (st & 1) == orient;
                int64_t j = go_fwd ? si + 1 : si - 1;
                if (j < 0 || base + j >= offsets[p + 1]) continue;
                if (per_path[p].empty()) touched.push_back(p);
                per_path[p].push_back({si, steps[base + j]});
            }
            std::sort(touched.begin(), touched.end());

            group_of.clear();
            SnarlParts& out = results[size_t(s)];
            std::vector<std::vector<int32_t>> members;
            std::vector<uint64_t> key;
            for (int32_t p : touched) {
                auto& cr = per_path[p];
                std::sort(cr.begin(), cr.end());
                key.clear();
                for (const auto& e : cr) key.push_back(e.second);
                auto ins = group_of.emplace(key, int32_t(members.size()));
                if (ins.second) members.emplace_back();
                members[size_t(ins.first->second)].push_back(p);
                cr.clear();
            }
            // distinct-sample case/control counts + smallest sample id
            std::set<int32_t> samples;
            for (auto& m : members) {
                samples.clear();
                for (int32_t p : m) samples.insert(path_sample[p]);
                uint32_t c1 = 0;
                for (int32_t sm : samples)
                    if (sample_case[sm]) ++c1;
                out.n_case.push_back(c1);
                out.n_ctrl.push_back(uint32_t(samples.size()) - c1);
                out.rep.push_back(*samples.begin());
            }
        }
    };
    std::vector<std::thread> pool;
    for (unsigned t = 1; t < nt; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();

    uint64_t total = 0;
    for (const auto& r : results) total += r.n_case.size();
    uint64_t* poffs = (uint64_t*)malloc((size_t(n_snarls) + 1) * 8);
    uint32_t* pc = (uint32_t*)malloc(total * 4 + 4);
    uint32_t* pt = (uint32_t*)malloc(total * 4 + 4);
    int32_t* pr = (int32_t*)malloc(total * 4 + 4);
    if (!poffs || !pc || !pt || !pr) return -1;
    uint64_t at = 0;
    for (long s = 0; s < n_snarls; ++s) {
        poffs[s] = at;
        const auto& r = results[size_t(s)];
        for (size_t i = 0; i < r.n_case.size(); ++i, ++at) {
            pc[at] = r.n_case[i];
            pt[at] = r.n_ctrl[i];
            pr[at] = r.rep[i];
        }
    }
    poffs[n_snarls] = at;
    *part_offs_out = poffs;
    *case_out = pc;
    *ctrl_out = pt;
    *rep_out = pr;
    return long(total);
}

// ---------------------------------------------------------------------------
// `stoat graph` end-to-end native prepare: GFA -> ready-to-write rows.
//
// Covers the whole graph-mode pipeline except the device statistics and
// the final TSV write: AssociationFinder::test_snarls' conditional tree
// walk (the reference's src/graph_path_association_finder.cpp:29-199)
// over natively-found snarls, with full get_walk_sets partitioning
// (partitioner.cpp:36-268) — start-bound refinement plus per-child
// refinement for irregular snarls.
//
// Inputs: the GFA path, reference sample names (CSV), the phenotype
// sample table ('\0'-joined names + case flags), "exact" vs "chi2", and
// the allele-size eligibility limit.
//
// Outputs (all malloc'd; free with free()/stoat_free_str):
//   rows_out      char*  — '\0'-joined row payloads in walk order.  For
//                          kind 0 (exact-match) rows: the COMPLETE tab-
//                          joined line (sans newline).  For kind 1
//                          (tested) rows: "<prefix>\x01<suffix>" where
//                          prefix = CHR..PATH_LENGTHS and suffix =
//                          GROUP_PATHS\tDEPTH; Python splices the
//                          device-computed P_FISHER/P_CHI2 between them.
//   kind_out      u8[n_rows]
//   part_offs_out u64[n_rows+1] — per-row partition ranges
//   g0/g1_out     u32[total]    — distinct case/control samples per
//                                 partition
// Returns n_rows (>= 0), or -1 (bad GFA), -2 (no phenotype paths).
static std::set<std::string> parse_csv_set(const char* csv_in) {
    std::set<std::string> out;
    if (!csv_in || !*csv_in) return out;
    std::string csv = csv_in;
    size_t start = 0;
    for (;;) {
        size_t pos = csv.find(',', start);
        std::string tok = csv.substr(
            start, pos == std::string::npos ? std::string::npos
                                            : pos - start);
        if (!tok.empty()) out.insert(tok);
        if (pos == std::string::npos) break;
        start = pos + 1;
    }
    return out;
}

static std::vector<std::string> parse_name_blob(const char* blob, long n) {
    std::vector<std::string> out;
    out.reserve(size_t(n));
    const char* p = blob;
    for (long i = 0; i < n; ++i) {
        out.emplace_back(p);
        p += out.back().size() + 1;
    }
    return out;
}

// Shared engine behind stoat_graph_assoc / stoat_graph_assoc_mem: the
// graph is already loaded; runs snarl finding + partitioning + the tree
// walk and emits either the TSV row payloads (kind/part_offs/g0/g1
// contract for the device chi²/Fisher splice) or, with fasta_mode, the
// complete FASTA text via rows_out (writer.cpp:89-178 semantics, byte-
// parity-pinned against association.py _write_fasta_partitions).
static long assoc_run(
        Graph& g, const std::set<std::string>& refs,
        const std::vector<std::string>& pheno_names,
        const uint8_t* pheno_case, int exact_mode, int fasta_mode,
        long allele_size_limit, long threads,
        char** rows_out, uint64_t* rows_len_out, uint8_t** kind_out,
        uint64_t** part_offs_out, uint32_t** g0_out, uint32_t** g1_out,
        long* n_snarls_out) {
    const bool prof = getenv("STOAT_PROFILE") &&
                      !strcmp(getenv("STOAT_PROFILE"), "1");
    auto now = [] {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    };
    const long n_pheno = long(pheno_names.size());
    g.build_index();         // dense CSR adjacency + length lookups
    double t1 = now();

    // phenotype sample table
    std::unordered_map<std::string, int32_t> pheno_id;
    for (long i = 0; i < n_pheno; ++i)
        pheno_id.emplace(pheno_names[size_t(i)], int32_t(i));
    long n_case_total = 0;
    for (long i = 0; i < n_pheno; ++i)
        if (pheno_case[i]) ++n_case_total;
    const long n_ctrl_total = n_pheno - n_case_total;

    // wanted paths (phenotype-matched), in g.paths order — the exact
    // filter of run_graph_association's sample_paths
    AssocIndex ix;
    for (const auto& p : g.paths) {
        auto it = pheno_id.find(p.sample);
        if (it == pheno_id.end()) continue;
        ix.steps.push_back(&p.steps);
        ix.path_sample.push_back(it->second);
    }
    const size_t n_paths = ix.steps.size();
    if (n_paths == 0) return -2;

    // the step index and the snarl finding both only READ the loaded
    // graph — overlap them
    std::thread ix_thread([&]() { ix.build(g); });
    Forest forest = find_snarls(g);
    ix_thread.join();
    double t2 = now();
    if (prof)
        fprintf(stderr,
                "[prof] graph_assoc: find||index=%.2fs\n", t2 - t1);
    const long S = long(forest.snarls.size());
    *n_snarls_out = S;

    // reference-path offsets in path order (_reference_offsets)
    std::vector<std::pair<std::string, std::unordered_map<uint64_t, long>>>
        ref_offsets;
    for (const auto& p : g.paths) {
        bool cand = !refs.empty()
                        ? (refs.count(p.name) || refs.count(p.sample))
                        : p.is_ref;
        if (!cand) continue;
        std::unordered_map<uint64_t, long> offs;
        long pos = 0;
        for (Handle st : p.steps) {
            offs.emplace(node_of(st), pos);
            pos += long(g.len_of(node_of(st)));
        }
        ref_offsets.push_back({p.name, std::move(offs)});
    }

    // ---- parallel per-snarl precompute: lengths, regularity, partitions
    struct PerSnarl {
        long mn = 0, mx = 0;
        std::vector<uint32_t> g0, g1;   // per partition (case, control)
        std::vector<int32_t> rep;       // fasta_mode: representative
                                        // sample id per partition (the
                                        // lexicographically-smallest
                                        // member name, sorted(p)[0])
    };
    std::vector<PerSnarl> pre{size_t(S)};
    // lexicographic rank of each phenotype sample name (fasta reps)
    std::vector<int32_t> name_rank;
    if (fasta_mode) {
        std::vector<int32_t> order(static_cast<size_t>(n_pheno), 0);
        for (long i = 0; i < n_pheno; ++i) order[size_t(i)] = int32_t(i);
        std::sort(order.begin(), order.end(),
                  [&](int32_t a, int32_t b) {
                      return pheno_names[size_t(a)] < pheno_names[size_t(b)];
                  });
        name_rank.assign(size_t(n_pheno), 0);
        for (long r = 0; r < n_pheno; ++r)
            name_rank[size_t(order[size_t(r)])] = int32_t(r);
    }
    unsigned nt = threads >= 1 ? unsigned(threads) : num_threads();
    std::atomic<long> next{0};
    auto worker = [&]() {
        std::vector<std::vector<std::pair<int32_t, Handle>>> per_path(
            n_paths);
        std::vector<int32_t> touched, inter_sets(n_paths), old_sets;
        std::vector<std::vector<int32_t>> members;
        // group keys/members as reused flat vectors: the former
        // std::map<vector,int> + per-group std::set cost ~50 node
        // allocations per snarl (the persnarl phase's malloc churn)
        std::vector<std::vector<Handle>> group_keys;
        std::vector<std::vector<int32_t>> group_members;
        std::vector<Handle> gkey;
        for (;;) {
            long s = next.fetch_add(1);
            if (s >= S) return;
            const Snarl& sn = forest.snarls[size_t(s)];
            PerSnarl& out = pre[size_t(s)];
            assoc_min_max_len(g, sn, &out.mn, &out.mx);
            if (out.mx < allele_size_limit) continue;   // walk skips it
            if (assoc_is_regular(g, sn)) {
                // regular snarls refine at the start bound only, from
                // the all-zeros state — grouping the touched paths by
                // their ordered next-handle key is the same partition
                // without the O(n_paths) renumber pass (the
                // stoat_graph_partitions fast loop; parity-pinned)
                const int64_t slot = ix.slot(node_of(sn.start));
                touched.clear();
                if (slot >= 0) {
                    const uint64_t orient = sn.start & 1;
                    for (uint64_t e = ix.ns_offs[size_t(slot)];
                         e < ix.ns_offs[size_t(slot) + 1]; ++e) {
                        int32_t p = ix.ns_entries[size_t(e)].first;
                        int32_t si = ix.ns_entries[size_t(e)].second;
                        const auto& steps = *ix.steps[size_t(p)];
                        bool fwd = (steps[size_t(si)] & 1) == orient;
                        int64_t j = fwd ? si + 1 : si - 1;
                        if (j < 0 || j >= int64_t(steps.size())) continue;
                        if (per_path[size_t(p)].empty())
                            touched.push_back(p);
                        per_path[size_t(p)].push_back(
                            {si, steps[size_t(j)]});
                    }
                    std::sort(touched.begin(), touched.end());
                }
                size_t n_groups = 0;
                for (int32_t p : touched) {
                    auto& cr = per_path[size_t(p)];
                    std::sort(cr.begin(), cr.end());
                    gkey.clear();
                    for (const auto& e : cr) gkey.push_back(e.second);
                    size_t gi = 0;
                    for (; gi < n_groups; ++gi)
                        if (group_keys[gi] == gkey) break;
                    if (gi == n_groups) {       // first appearance order
                        if (group_keys.size() <= gi) {
                            group_keys.emplace_back();
                            group_members.emplace_back();
                        }
                        group_keys[gi] = gkey;
                        group_members[gi].clear();
                        ++n_groups;
                    }
                    group_members[gi].push_back(
                        ix.path_sample[size_t(p)]);
                    cr.clear();
                }
                for (size_t gi = 0; gi < n_groups; ++gi) {
                    auto& gs = group_members[gi];
                    std::sort(gs.begin(), gs.end());
                    gs.erase(std::unique(gs.begin(), gs.end()),
                             gs.end());
                    uint32_t c = 0, t = 0;
                    int32_t best = -1;
                    for (int32_t sm : gs) {
                        if (pheno_case[sm]) ++c; else ++t;
                        if (fasta_mode &&
                            (best < 0 || name_rank[size_t(sm)] <
                                             name_rank[size_t(best)]))
                            best = sm;
                    }
                    out.g0.push_back(c);
                    out.g1.push_back(t);
                    if (fasta_mode) out.rep.push_back(best);
                }
                continue;
            }
            old_sets.assign(n_paths, 0);
            int32_t set_count = 1;
            assoc_refine(ix, sn.start, old_sets, set_count, per_path,
                         touched, inter_sets);
            for (Handle h : assoc_child_handles(forest, int(s)))
                assoc_refine(ix, h, old_sets, set_count, per_path,
                             touched, inter_sets);
            // distinct-sample case/control counts per set, set-id order,
            // empties skipped (partition_samples_in_snarl's return)
            if (members.size() < size_t(set_count))
                members.resize(size_t(set_count));
            for (int32_t sid = 0; sid < set_count; ++sid)
                members[size_t(sid)].clear();
            for (size_t i = 0; i < n_paths; ++i)
                if (old_sets[i] != 0)
                    members[size_t(old_sets[i])].push_back(
                        ix.path_sample[i]);
            for (int32_t sid = 1; sid < set_count; ++sid) {
                auto& gs = members[size_t(sid)];
                if (gs.empty()) continue;
                std::sort(gs.begin(), gs.end());
                gs.erase(std::unique(gs.begin(), gs.end()), gs.end());
                uint32_t c = 0, t = 0;
                int32_t best = -1;
                for (int32_t sm : gs) {
                    if (pheno_case[sm]) ++c; else ++t;
                    if (fasta_mode &&
                        (best < 0 || name_rank[size_t(sm)] <
                                         name_rank[size_t(best)]))
                        best = sm;
                }
                out.g0.push_back(c);
                out.g1.push_back(t);
                if (fasta_mode) out.rep.push_back(best);
            }
        }
    };
    double t3 = now();
    std::vector<std::thread> pool;
    for (unsigned t = 1; t < nt; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    if (prof)
        fprintf(stderr, "[prof] graph_assoc: refoffs=%.2fs persnarl=%.2fs\n",
                t3 - t2, now() - t3);

    if (fasta_mode) {
        // ---- FASTA output (writer.cpp:89-178; mirrors association.py
        // _write_fasta_partitions byte for byte) ----
        // complement table (gfa.py _COMPLEMENT: ACGTacgtNn -> TGCAtgcaNn,
        // other characters unchanged)
        static const auto kComp = [] {
            std::array<char, 256> t{};
            for (int i = 0; i < 256; ++i) t[size_t(i)] = char(i);
            const char* a = "ACGTacgtNn";
            const char* b = "TGCAtgcaNn";
            for (int i = 0; a[i]; ++i)
                t[size_t((unsigned char)a[i])] = b[i];
            return t;
        }();
        auto append_seq = [&](Handle st, std::string& out) {
            auto it = g.seq.find(node_of(st));
            if (it == g.seq.end()) return;
            const std::string& s = it->second;
            if (!(st & 1)) {
                out += s;
            } else {
                for (size_t k = s.size(); k-- > 0;)
                    out += kComp[size_t((unsigned char)s[k])];
            }
        };
        // cumulative step offsets per phenotype path
        std::vector<std::vector<long>> poffs(n_paths);
        for (size_t p = 0; p < n_paths; ++p) {
            const auto& sv = *ix.steps[p];
            poffs[p].resize(sv.size());
            long pos = 0;
            for (size_t k = 0; k < sv.size(); ++k) {
                poffs[p][k] = pos;
                pos += long(g.len_of(node_of(sv[k])));
            }
        }
        // reference candidate paths (same filter as ref_offsets) with
        // their own step index + offsets
        struct RefCand {
            const GPath* p;
            std::vector<long> offs;
        };
        std::vector<RefCand> ref_cands;
        for (const auto& p : g.paths) {
            bool cand = !refs.empty()
                            ? (refs.count(p.name) || refs.count(p.sample))
                            : p.is_ref;
            if (!cand) continue;
            RefCand rc;
            rc.p = &p;
            rc.offs.resize(p.steps.size());
            long pos = 0;
            for (size_t k = 0; k < p.steps.size(); ++k) {
                rc.offs[k] = pos;
                pos += long(g.len_of(node_of(p.steps[k])));
            }
            ref_cands.push_back(std::move(rc));
        }
        AssocIndex rix;
        for (auto& c : ref_cands) rix.steps.push_back(&c.p->steps);
        if (!ref_cands.empty()) rix.build(g);

        // step indices on either boundary node, grouped per path
        auto boundary_steps =
            [&](const AssocIndex& index, uint64_t a, uint64_t b,
                std::map<int32_t, std::vector<int32_t>>& per) {
                per.clear();
                int64_t sa = index.slot(a);
                if (sa >= 0)
                    for (uint64_t e = index.ns_offs[size_t(sa)];
                         e < index.ns_offs[size_t(sa) + 1]; ++e)
                        per[index.ns_entries[size_t(e)].first].push_back(
                            index.ns_entries[size_t(e)].second);
                if (b != a) {
                    int64_t sb = index.slot(b);
                    if (sb >= 0)
                        for (uint64_t e = index.ns_offs[size_t(sb)];
                             e < index.ns_offs[size_t(sb) + 1]; ++e)
                            per[index.ns_entries[size_t(e)].first]
                                .push_back(
                                    index.ns_entries[size_t(e)].second);
                }
                for (auto& [pi, v] : per) std::sort(v.begin(), v.end());
            };
        // consecutive boundary-step pairs with strictly-interior steps
        // between (association.py traversals(); a pair may join two
        // visits of the SAME bound)
        auto traversal_ok = [&](const std::vector<Handle>& sv,
                                const std::set<uint64_t>& interior,
                                int32_t i, int32_t j) {
            for (int32_t k = i + 1; k < j; ++k)
                if (!interior.count(node_of(sv[size_t(k)]))) return false;
            return true;
        };

        std::string fasta;
        std::map<int32_t, std::vector<int32_t>> per, rper;
        auto emit_fasta = [&](int si_idx, const PerSnarl& pc) {
            const Snarl& sn = forest.snarls[size_t(si_idx)];
            const uint64_t a = node_of(sn.start), b = node_of(sn.end);
            char hdr[256];
            // reference range through the snarl (NOREF:?:? when absent)
            std::string ref_coord = "NOREF:?:?";
            if (!ref_cands.empty()) {
                boundary_steps(rix, a, b, rper);
                for (size_t c = 0; c < ref_cands.size(); ++c) {
                    auto it = rper.find(int32_t(c));
                    if (it == rper.end()) continue;
                    const auto& sv = ref_cands[c].p->steps;
                    const auto& offs = ref_cands[c].offs;
                    bool found = false;
                    const auto& idxs = it->second;
                    for (size_t k = 0; k + 1 < idxs.size(); ++k) {
                        int32_t i = idxs[k], j = idxs[k + 1];
                        if (!traversal_ok(sv, sn.interior, i, j)) continue;
                        long so = offs[size_t(i)] +
                                  long(g.len_of(node_of(sv[size_t(i)])));
                        snprintf(hdr, sizeof hdr, ":%ld-%ld", so,
                                 offs[size_t(j)]);
                        ref_coord = ref_cands[c].p->name + hdr;
                        found = true;
                        break;
                    }
                    if (found) break;
                }
            }
            std::set<int32_t> write_ids(pc.rep.begin(), pc.rep.end());
            for (size_t p = 0; p < n_paths; ++p) {
                if (!write_ids.empty() &&
                    !write_ids.count(ix.path_sample[p]))
                    continue;
                auto it = per.find(int32_t(p));
                if (it == per.end()) continue;
                const auto& sv = *ix.steps[p];
                const auto& idxs = it->second;
                for (size_t k = 0; k + 1 < idxs.size(); ++k) {
                    int32_t i = idxs[k], j = idxs[k + 1];
                    if (!traversal_ok(sv, sn.interior, i, j)) continue;
                    std::string seq;
                    for (int32_t q = i + 1; q < j; ++q)
                        append_seq(sv[size_t(q)], seq);
                    long so = poffs[p][size_t(i)] +
                              long(g.len_of(node_of(sv[size_t(i)])));
                    // header via std::string — names are unbounded
                    // (long PanSN sample/contig names must not truncate)
                    snprintf(hdr, sizeof hdr, ">snarl:%llu-%llu|",
                             (unsigned long long)a,
                             (unsigned long long)b);
                    fasta += hdr;
                    fasta += ref_coord;
                    fasta += '|';
                    fasta += pheno_names[size_t(ix.path_sample[p])];
                    snprintf(hdr, sizeof hdr, ":%ld-%ld\n", so,
                             poffs[p][size_t(j)]);
                    fasta += hdr;
                    for (size_t q = 0; q < seq.size(); q += 80) {
                        fasta.append(seq, q, 80);
                        fasta += '\n';
                    }
                    if (seq.empty()) fasta += '\n';
                }
            }
        };

        std::vector<int> fstack;
        for (long i = 0; i < S; ++i)
            if (forest.snarls[size_t(i)].parent == -1)
                fstack.push_back(int(i));
        std::sort(fstack.begin(), fstack.end(), std::greater<int>());
        while (!fstack.empty()) {
            int i = fstack.back();
            fstack.pop_back();
            const Snarl& sn = forest.snarls[size_t(i)];
            const PerSnarl& pc = pre[size_t(i)];
            if (pc.mx < allele_size_limit) continue;
            bool descend = true;
            if (pc.g0.size() > 1) {
                bool write = !exact_mode;
                if (exact_mode) {
                    for (size_t k = 0; k < pc.g0.size(); ++k) {
                        if ((pc.g1[k] == 0 &&
                             long(pc.g0[k]) == n_case_total) ||
                            (pc.g0[k] == 0 &&
                             long(pc.g1[k]) == n_ctrl_total)) {
                            write = true;
                            descend = false;
                        }
                    }
                }
                if (write) {
                    boundary_steps(ix, node_of(sn.start), node_of(sn.end),
                                   per);
                    emit_fasta(i, pc);
                }
            }
            if (descend) {
                std::vector<int> kids(sn.children);
                std::sort(kids.begin(), kids.end(), std::greater<int>());
                for (int c : kids) fstack.push_back(c);
            }
        }
        char* rb = (char*)malloc(fasta.size() + 1);
        uint8_t* kb = (uint8_t*)malloc(1);
        uint64_t* po = (uint64_t*)malloc(8);
        uint32_t* g0b = (uint32_t*)malloc(4);
        uint32_t* g1b = (uint32_t*)malloc(4);
        if (!rb || !kb || !po || !g0b || !g1b) {
            free(rb); free(kb); free(po); free(g0b); free(g1b);
            return -3;
        }
        memcpy(rb, fasta.data(), fasta.size());
        rb[fasta.size()] = '\0';
        *rows_len_out = uint64_t(fasta.size());
        po[0] = 0;
        *rows_out = rb;
        *kind_out = kb;
        *part_offs_out = po;
        *g0_out = g0b;
        *g1_out = g1b;
        return 0;
    }

    // ---- serial tree walk (test_snarls order, conditional descent)
    std::string rows_blob;
    std::vector<uint8_t> kinds;
    std::vector<uint64_t> part_offs{0};
    std::vector<uint32_t> g0_flat, g1_flat;
    std::vector<int> stack;
    for (long i = 0; i < S; ++i)
        if (forest.snarls[size_t(i)].parent == -1) stack.push_back(int(i));
    std::sort(stack.begin(), stack.end(), std::greater<int>());
    // worst case: 6 20-digit integers + separators (~130 chars)
    auto format_prefix = [&](const Snarl& sn, const PerSnarl& pc,
                             std::string& prefix) {
        char buf[192];
        std::string chrom = "NA";
        long a = 0, b = 0;
        const uint64_t snode = node_of(sn.start), enode = node_of(sn.end);
        for (const auto& [nm, offs] : ref_offsets) {
            auto ia = offs.find(snode);
            if (ia == offs.end()) continue;
            auto ib = offs.find(enode);
            if (ib == offs.end()) continue;
            long x = ia->second, y = ib->second;
            uint64_t first = snode;
            if (x > y) {
                std::swap(x, y);
                first = enode;
            }
            chrom = nm;
            a = x + long(g.len_of(first));
            b = y;
            break;
        }
        prefix = chrom;
        snprintf(buf, sizeof buf,
                 "\t%ld\t%ld\t%llu_%llu\t%ld,%ld", a, b,
                 (unsigned long long)snode, (unsigned long long)enode,
                 pc.mn, pc.mx);
        prefix += buf;
    };
    if (!exact_mode) {
        // chi2 descends unconditionally, so the visit order is a pure
        // function of the forest + allele-length skips: collect it
        // serially (cheap), format the row payloads in parallel, then
        // assemble in order.
        std::vector<int> order;
        order.reserve(size_t(S));
        while (!stack.empty()) {
            int i = stack.back();
            stack.pop_back();
            const Snarl& sn = forest.snarls[size_t(i)];
            if (pre[size_t(i)].mx < allele_size_limit) continue;
            order.push_back(i);
            std::vector<int> kids(sn.children);
            std::sort(kids.begin(), kids.end(), std::greater<int>());
            for (int c : kids) stack.push_back(c);
        }
        std::vector<std::string> row_str(order.size());
        std::atomic<size_t> rnext{0};
        auto rworker = [&]() {
            char buf[192];
            for (;;) {
                size_t oi = rnext.fetch_add(1);
                if (oi >= order.size()) return;
                int i = order[oi];
                const Snarl& sn = forest.snarls[size_t(i)];
                const PerSnarl& pc = pre[size_t(i)];
                if (pc.g0.size() <= 1) continue;       // no row
                std::string& out = row_str[oi];
                format_prefix(sn, pc, out);
                out += '\x01';
                for (size_t k = 0; k < pc.g0.size(); ++k) {
                    if (k) out += ',';
                    snprintf(buf, sizeof buf, "%u:%u", pc.g0[k],
                             pc.g1[k]);
                    out += buf;
                }
                snprintf(buf, sizeof buf, "\t%d", sn.depth);
                out += buf;
            }
        };
        std::vector<std::thread> rpool;
        for (unsigned t = 1; t < nt; ++t) rpool.emplace_back(rworker);
        rworker();
        for (auto& th : rpool) th.join();
        for (size_t oi = 0; oi < order.size(); ++oi) {
            if (row_str[oi].empty()) continue;
            const PerSnarl& pc = pre[size_t(order[oi])];
            rows_blob += row_str[oi];
            rows_blob += '\0';
            kinds.push_back(1);
            for (size_t k = 0; k < pc.g0.size(); ++k) {
                g0_flat.push_back(pc.g0[k]);
                g1_flat.push_back(pc.g1[k]);
            }
            part_offs.push_back(uint64_t(g0_flat.size()));
        }
    } else {
        char buf[192];
        while (!stack.empty()) {
            int i = stack.back();
            stack.pop_back();
            const Snarl& sn = forest.snarls[size_t(i)];
            const PerSnarl& pc = pre[size_t(i)];
            if (pc.mx < allele_size_limit) continue;
            bool descend = true;
            if (pc.g0.size() > 1) {
                bool matched = false;
                for (size_t k = 0; k < pc.g0.size(); ++k) {
                    if ((pc.g1[k] == 0 &&
                         long(pc.g0[k]) == n_case_total) ||
                        (pc.g0[k] == 0 &&
                         long(pc.g1[k]) == n_ctrl_total)) {
                        matched = true;
                        descend = false;
                    }
                }
                if (matched) {
                    std::string prefix;
                    format_prefix(sn, pc, prefix);
                    snprintf(buf, sizeof buf, "\tNA\tNA\tNA\t%d",
                             sn.depth);
                    rows_blob += prefix;
                    rows_blob += buf;
                    rows_blob += '\0';
                    kinds.push_back(0);
                    part_offs.push_back(uint64_t(g0_flat.size()));
                }
            }
            if (descend) {
                std::vector<int> kids(sn.children);
                std::sort(kids.begin(), kids.end(), std::greater<int>());
                for (int c : kids) stack.push_back(c);
            }
        }
    }

    const long n_rows = long(kinds.size());
    char* rb = (char*)malloc(rows_blob.size() + 1);
    uint8_t* kb = (uint8_t*)malloc(size_t(n_rows) + 1);
    uint64_t* po = (uint64_t*)malloc(part_offs.size() * 8);
    uint32_t* g0b = (uint32_t*)malloc(g0_flat.size() * 4 + 4);
    uint32_t* g1b = (uint32_t*)malloc(g1_flat.size() * 4 + 4);
    if (!rb || !kb || !po || !g0b || !g1b) {
        free(rb); free(kb); free(po); free(g0b); free(g1b);
        return -3;
    }
    memcpy(rb, rows_blob.data(), rows_blob.size());
    rb[rows_blob.size()] = '\0';
    *rows_len_out = uint64_t(rows_blob.size());
    memcpy(kb, kinds.data(), kinds.size());
    memcpy(po, part_offs.data(), part_offs.size() * 8);
    memcpy(g0b, g0_flat.data(), g0_flat.size() * 4);
    memcpy(g1b, g1_flat.data(), g1_flat.size() * 4);
    *rows_out = rb;
    *kind_out = kb;
    *part_offs_out = po;
    *g0_out = g0b;
    *g1_out = g1b;
    return n_rows;
}


long stoat_graph_assoc(
        const char* gfa_path, const char* ref_names_csv,
        const char* pheno_names_blob, long n_pheno,
        const uint8_t* pheno_case, int exact_mode, int fasta_mode,
        long allele_size_limit, long threads,
        char** rows_out, uint64_t* rows_len_out, uint8_t** kind_out,
        uint64_t** part_offs_out, uint32_t** g0_out, uint32_t** g1_out,
        long* n_snarls_out) {
    std::set<std::string> refs = parse_csv_set(ref_names_csv);
    const bool prof = getenv("STOAT_PROFILE") &&
                      !strcmp(getenv("STOAT_PROFILE"), "1");
    auto now = [] {
        return std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
            .count();
    };
    double t0 = now();
    Graph g;
    if (!load_gfa(gfa_path, refs, g, fasta_mode != 0)) return -1;
    if (prof)
        fprintf(stderr, "[prof] graph_assoc: load=%.2fs\n", now() - t0);
    return assoc_run(g, refs,
                     parse_name_blob(pheno_names_blob, n_pheno),
                     pheno_case, exact_mode, fasta_mode,
                     allele_size_limit, threads, rows_out, rows_len_out,
                     kind_out, part_offs_out, g0_out, g1_out,
                     n_snarls_out);
}


// In-memory graph entry: the same engine fed from flat arrays — the
// production path for the reference's binary formats (.hg/.pg/.gbz,
// graph.cpp:217-224 VPKG load): Python's format readers decode the
// container, then hand the graph over once and the whole prepare runs
// native.  ``edges`` are handle pairs ((id<<1)|rev); ``seq_blob`` +
// ``seq_offs`` are optional (FASTA mode only).
long stoat_graph_assoc_mem(
        const uint64_t* node_ids, const uint32_t* node_lens, long n_nodes,
        const char* seq_blob, const uint64_t* seq_offs,
        const uint64_t* edges, long n_edges,
        const uint64_t* steps, const int64_t* step_offs, long n_gpaths,
        const char* path_names_blob, const char* path_samples_blob,
        const uint8_t* path_is_ref, const char* ref_names_csv,
        const char* pheno_names_blob, long n_pheno,
        const uint8_t* pheno_case, int exact_mode, int fasta_mode,
        long allele_size_limit, long threads,
        char** rows_out, uint64_t* rows_len_out, uint8_t** kind_out,
        uint64_t** part_offs_out, uint32_t** g0_out, uint32_t** g1_out,
        long* n_snarls_out) {
    Graph g;
    for (long i = 0; i < n_nodes; ++i) {
        g.node_len[node_ids[i]] = node_lens[i];
        if (seq_blob && seq_offs)
            g.seq[node_ids[i]].assign(
                seq_blob + seq_offs[i],
                size_t(seq_offs[i + 1] - seq_offs[i]));
    }
    // the caller ships the full directed successor relation (already
    // symmetric-closed), so add_succ preserves its exact adjacency order
    for (long e = 0; e < n_edges; ++e)
        g.add_succ(Handle(edges[2 * e]), Handle(edges[2 * e + 1]));
    {
        const char* pn = path_names_blob;
        const char* ps = path_samples_blob;
        for (long p = 0; p < n_gpaths; ++p) {
            GPath gp;
            gp.name = pn;
            pn += gp.name.size() + 1;
            gp.sample = ps;
            ps += gp.sample.size() + 1;
            gp.is_ref = path_is_ref[p] != 0;
            gp.steps.assign(steps + step_offs[p], steps + step_offs[p + 1]);
            g.paths.push_back(std::move(gp));
        }
    }
    return assoc_run(g, parse_csv_set(ref_names_csv),
                     parse_name_blob(pheno_names_blob, n_pheno),
                     pheno_case, exact_mode, fasta_mode,
                     allele_size_limit, threads, rows_out, rows_len_out,
                     kind_out, part_offs_out, g0_out, g1_out,
                     n_snarls_out);
}

}  // extern "C"
