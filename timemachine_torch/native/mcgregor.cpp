// Native McGregor maximum-common-subgraph search.
//
// C++ implementation of the best-first MARCS branch-and-bound in
// timemachine_torch/fe/mcgregor.py (the CPU-bound combinatorial hot loop of
// RBFE network setup; 50-200x faster than the Python search). Semantics
// mirror the Python module: edge-count objective, arcs_left bound,
// connected-component constraints, core-core edge preservation, optional
// Python filter callbacks (invoked through C function pointers).
//
// Reference algorithm: J.J. McGregor, Softw. Pract. Exper. 12 (1982) 23-34;
// reference Python spec: timemachine/fe/mcgregor.py.
//
// Built as a shared library via timemachine_torch/native/__init__.py (ctypes);
// a copy of timemachine_tpu/native/mcgregor.cpp.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int32_t UNMAPPED = -1;

typedef int (*filter_cb)(const int32_t *a_to_b, int n);

struct Graph {
    int n_vertices;
    int n_edges;
    std::vector<std::array<int32_t, 2>> edges;
    std::vector<std::vector<int32_t>> vertex_edges;
    std::vector<std::vector<int32_t>> neighbors;
    std::vector<uint8_t> adj; // n_vertices * n_vertices

    Graph(int nv, const int32_t *bonds, int nb) : n_vertices(nv), n_edges(nb) {
        edges.resize(nb);
        vertex_edges.resize(nv);
        neighbors.resize(nv);
        adj.assign((size_t)nv * nv, 0);
        for (int e = 0; e < nb; e++) {
            int32_t i = bonds[2 * e], j = bonds[2 * e + 1];
            edges[e] = {i, j};
            adj[(size_t)i * nv + j] = 1;
            adj[(size_t)j * nv + i] = 1;
            vertex_edges[i].push_back(e);
            vertex_edges[j].push_back(e);
        }
        for (int v = 0; v < nv; v++) {
            for (int w = 0; w < nv; w++) {
                if (adj[(size_t)v * nv + w]) neighbors[v].push_back(w);
            }
        }
    }

    bool has_edge(int i, int j) const { return adj[(size_t)i * n_vertices + j] != 0; }

    // true if the partial mapping can no longer satisfy the CC constraints
    // (mirror of _Graph.cc_constraints_violated)
    bool cc_violated(const std::vector<uint8_t> &mapped, const std::vector<uint8_t> &unvisited, int max_ccs,
                     int min_cc_size) const {
        std::vector<uint8_t> seen(n_vertices, 0);
        int n_ccs = 0;
        int n_mapped = 0;
        for (int v = 0; v < n_vertices; v++) n_mapped += mapped[v];
        int mapped_seen_total = 0;
        std::vector<int32_t> frontier;
        for (int u = 0; u < n_vertices; u++) {
            if (!mapped[u] || seen[u]) continue;
            seen[u] = 1;
            int cc_size = 1;
            int mapped_in_cc = 1;
            frontier.clear();
            frontier.push_back(u);
            while (!frontier.empty()) {
                int v = frontier.back();
                frontier.pop_back();
                for (int w : neighbors[v]) {
                    if ((mapped[w] || unvisited[w]) && !seen[w]) {
                        seen[w] = 1;
                        cc_size++;
                        if (mapped[w]) mapped_in_cc++;
                        frontier.push_back(w);
                    }
                }
            }
            n_ccs++;
            mapped_seen_total += mapped_in_cc;
            if (cc_size < min_cc_size) return true;
            if (max_ccs > 0 && n_ccs == max_ccs && mapped_seen_total < n_mapped) return true;
        }
        return false;
    }
};

// MARCS stored as bitset rows: one row per edge of A, bits over edges of B.
struct Search {
    const Graph &ga, &gb;
    int words;          // uint64 words per row
    int n_a, n_b;
    const std::vector<std::vector<int32_t>> &priority;
    filter_cb filter, leaf_filter;
    int enforce_core_core;
    int max_ccs;
    int min_cc_size;

    Search(const Graph &a, const Graph &b, int na, int nb, const std::vector<std::vector<int32_t>> &prio,
           filter_cb f, filter_cb lf, int ecc, int mccs, int mcc_size)
        : ga(a), gb(b), words((b.n_edges + 63) / 64), n_a(na), n_b(nb), priority(prio), filter(f), leaf_filter(lf),
          enforce_core_core(ecc), max_ccs(mccs), min_cc_size(mcc_size) {}

    struct Node {
        std::vector<int32_t> a_to_b; // n_a
        std::vector<int32_t> b_to_a; // n_b
        std::vector<uint64_t> marcs; // n_edges_a * words
        int layer;
        int bound;
        uint64_t seq; // FIFO tiebreak for determinism
    };

    struct NodeCmp {
        // max-heap on (bound, layer), FIFO among ties
        bool operator()(const Node *x, const Node *y) const {
            if (x->bound != y->bound) return x->bound < y->bound;
            if (x->layer != y->layer) return x->layer < y->layer;
            return x->seq > y->seq;
        }
    };

    int arcs_left(const std::vector<uint64_t> &marcs) const {
        int rows = 0;
        std::vector<uint64_t> col_or(words, 0);
        for (int e = 0; e < ga.n_edges; e++) {
            uint64_t any = 0;
            const uint64_t *row = &marcs[(size_t)e * words];
            for (int w = 0; w < words; w++) {
                any |= row[w];
                col_or[w] |= row[w];
            }
            rows += any != 0;
        }
        int cols = 0;
        for (int w = 0; w < words; w++) cols += __builtin_popcountll(col_or[w]);
        return rows < cols ? rows : cols;
    }

    // refine for assignment v_a -> v_b (v_b == UNMAPPED zeroes rows of v_a's edges)
    void refine(const std::vector<uint64_t> &src, std::vector<uint64_t> &dst, int v_a, int v_b) const {
        dst = src;
        if (v_b == UNMAPPED) {
            for (int e : ga.vertex_edges[v_a]) {
                std::memset(&dst[(size_t)e * words], 0, sizeof(uint64_t) * words);
            }
            return;
        }
        // row-side: edges of v_a keep only columns that are edges of v_b;
        // other rows drop columns that are edges of v_b
        std::vector<uint64_t> eb_mask(words, 0);
        for (int e : gb.vertex_edges[v_b]) eb_mask[e / 64] |= (uint64_t)1 << (e % 64);
        std::vector<uint8_t> is_ea(ga.n_edges, 0);
        for (int e : ga.vertex_edges[v_a]) is_ea[e] = 1;
        for (int e = 0; e < ga.n_edges; e++) {
            uint64_t *row = &dst[(size_t)e * words];
            if (is_ea[e]) {
                for (int w = 0; w < words; w++) row[w] &= eb_mask[w];
            } else {
                for (int w = 0; w < words; w++) row[w] &= ~eb_mask[w];
            }
        }
    }

    bool core_preserves_edges(int v_a, int v_b, const std::vector<int32_t> &a_to_b,
                              const std::vector<int32_t> &b_to_a) const {
        for (int e : ga.vertex_edges[v_a]) {
            int i = ga.edges[e][0], j = ga.edges[e][1];
            int mi = a_to_b[i], mj = a_to_b[j];
            if (mi != UNMAPPED && mj != UNMAPPED && !gb.has_edge(mi, mj)) return false;
        }
        for (int e : gb.vertex_edges[v_b]) {
            int i = gb.edges[e][0], j = gb.edges[e][1];
            int mi = b_to_a[i], mj = b_to_a[j];
            if (mi != UNMAPPED && mj != UNMAPPED && !ga.has_edge(mi, mj)) return false;
        }
        return true;
    }

    bool cc_ok(const Node &node) const {
        if (max_ccs <= 0 && min_cc_size <= 1) return true;
        std::vector<uint8_t> mapped_a(n_a, 0);
        bool any_a = false;
        for (int a = 0; a < node.layer && a < n_a; a++) {
            if (node.a_to_b[a] != UNMAPPED) {
                mapped_a[a] = 1;
                any_a = true;
            }
        }
        if (any_a) {
            std::vector<uint8_t> unvisited_a(n_a, 0);
            for (int a = node.layer; a < n_a; a++) unvisited_a[a] = 1;
            if (ga.cc_violated(mapped_a, unvisited_a, max_ccs, min_cc_size)) return false;
        }
        std::vector<uint8_t> mapped_b(n_b, 0);
        bool any_b = false;
        for (int b = 0; b < n_b; b++) {
            if (node.b_to_a[b] != UNMAPPED) {
                mapped_b[b] = 1;
                any_b = true;
            }
        }
        if (any_b) {
            std::vector<uint8_t> unvisited_b(n_b, 0);
            for (int layer = node.layer; layer < n_a; layer++) {
                for (int b : priority[layer]) {
                    if (!mapped_b[b]) unvisited_b[b] = 1;
                }
            }
            if (gb.cc_violated(mapped_b, unvisited_b, max_ccs, min_cc_size)) return false;
        }
        return true;
    }
};

struct VecHash {
    size_t operator()(const std::vector<int32_t> &v) const {
        size_t h = 1469598103934665603ull;
        for (int32_t x : v) {
            h ^= (size_t)(uint32_t)x;
            h *= 1099511628211ull;
        }
        return h;
    }
};

} // namespace

static inline uint64_t pack_quartet(int32_t a, int32_t b, int32_t c, int32_t d) {
    // UNMAPPED (-1) packs to 0xFFFF, which never collides with a valid index
    return ((uint64_t)(uint16_t)a << 48) | ((uint64_t)(uint16_t)b << 32) | ((uint64_t)(uint16_t)c << 16) |
           (uint64_t)(uint16_t)d;
}

extern "C" {

// returns: 0 ok, 1 no-mapping (predicate empty), 2 no valid cores found,
//          3 below min_num_edges
//
// Built-in filters (the atom-mapping hot path; ~1e5-1e6 invocations per
// search made these prohibitive as Python callbacks):
//   chiral flips:   quartets of A whose image lies in B's disallowed set
//   planar flips:   planar torsions of A whose image has opposite sign in B
int mcs_search(int n_a, int n_b, const int32_t *priority_flat, const int32_t *priority_offsets,
               const int32_t *bonds_a, int n_bonds_a, const int32_t *bonds_b, int n_bonds_b, int64_t max_visits,
               int64_t max_cores, int enforce_core_core, int max_ccs, int min_cc_size, int min_num_edges,
               const int32_t *init_mapping, int n_init, filter_cb filter, filter_cb leaf_filter,
               const int32_t *chiral_quartets_a, int n_chiral_a, const uint64_t *disallowed_b_keys,
               int n_disallowed_b, const int32_t *planar_torsions_a, const int8_t *planar_signs_a, int n_planar_a,
               const uint64_t *planar_b_keys, const int8_t *planar_b_signs, int n_planar_b, int32_t *out_maps,
               int32_t *out_n_maps, int64_t *out_nodes_visited, int64_t *out_leaves_visited, int *out_timed_out) {
    Graph ga(n_a, bonds_a, n_bonds_a);
    Graph gb(n_b, bonds_b, n_bonds_b);

    std::vector<std::vector<int32_t>> priority(n_a);
    for (int i = 0; i < n_a; i++) {
        for (int32_t k = priority_offsets[i]; k < priority_offsets[i + 1]; k++) {
            priority[i].push_back(priority_flat[k]);
        }
    }

    Search S(ga, gb, n_a, n_b, priority, filter, leaf_filter, enforce_core_core, max_ccs, min_cc_size);
    const int words = S.words;

    // predicate + initial marcs
    std::vector<uint8_t> predicate((size_t)n_a * n_b, 0);
    for (int i = 0; i < n_a; i++) {
        for (int32_t j : priority[i]) predicate[(size_t)i * n_b + j] = 1;
    }
    auto root = new Search::Node();
    root->a_to_b.assign(n_a, UNMAPPED);
    root->b_to_a.assign(n_b, UNMAPPED);
    root->marcs.assign((size_t)n_bonds_a * words, 0);
    for (int ea = 0; ea < n_bonds_a; ea++) {
        int sa = ga.edges[ea][0], da = ga.edges[ea][1];
        for (int eb = 0; eb < n_bonds_b; eb++) {
            int sb = gb.edges[eb][0], db = gb.edges[eb][1];
            bool ok = (predicate[(size_t)sa * n_b + sb] && predicate[(size_t)da * n_b + db]) ||
                      (predicate[(size_t)sa * n_b + db] && predicate[(size_t)da * n_b + sb]);
            if (ok) root->marcs[(size_t)ea * words + eb / 64] |= (uint64_t)1 << (eb % 64);
        }
    }
    root->layer = 0;
    root->seq = 0;
    root->bound = S.arcs_left(root->marcs);

    // apply initial mapping (a index -> b, in order of a = 0..n_init-1)
    if (n_init > 0) {
        std::unordered_map<int32_t, int32_t> init_kv;
        for (int k = 0; k < n_init; k++) init_kv[init_mapping[2 * k]] = init_mapping[2 * k + 1];
        for (int a = 0; a < n_init; a++) {
            int b = init_kv.count(a) ? init_kv[a] : UNMAPPED;
            auto nxt = new Search::Node();
            nxt->a_to_b = root->a_to_b;
            nxt->b_to_a = root->b_to_a;
            nxt->a_to_b[root->layer] = b;
            if (b != UNMAPPED) nxt->b_to_a[b] = root->layer;
            S.refine(root->marcs, nxt->marcs, root->layer, b);
            nxt->layer = root->layer + 1;
            nxt->seq = 0;
            nxt->bound = S.arcs_left(nxt->marcs);
            delete root;
            root = nxt;
        }
    }

    if (root->bound == 0) {
        delete root;
        return 1;
    }

    std::unordered_set<uint64_t> disallowed_b(disallowed_b_keys, disallowed_b_keys + n_disallowed_b);
    std::unordered_map<uint64_t, int8_t> planar_b;
    planar_b.reserve(n_planar_b);
    for (int k = 0; k < n_planar_b; k++) planar_b.emplace(planar_b_keys[k], planar_b_signs[k]);

    auto passes_builtin_filters = [&](const std::vector<int32_t> &a_to_b) -> bool {
        for (int q = 0; q < n_chiral_a; q++) {
            const int32_t *t = &chiral_quartets_a[4 * q];
            uint64_t key = pack_quartet(a_to_b[t[0]], a_to_b[t[1]], a_to_b[t[2]], a_to_b[t[3]]);
            if (disallowed_b.count(key)) return false;
        }
        for (int q = 0; q < n_planar_a; q++) {
            const int32_t *t = &planar_torsions_a[4 * q];
            uint64_t key = pack_quartet(a_to_b[t[0]], a_to_b[t[1]], a_to_b[t[2]], a_to_b[t[3]]);
            auto it = planar_b.find(key);
            if (it != planar_b.end() && it->second != planar_signs_a[q]) return false;
        }
        return true;
    };

    std::priority_queue<Search::Node *, std::vector<Search::Node *>, Search::NodeCmp> queue;
    queue.push(root);
    uint64_t seq_counter = 1;
    int best_num_edges = min_num_edges;
    int64_t nodes_visited = 0, leaves_visited = 0;
    int n_maps = 0;
    bool timed_out = false;
    std::unordered_map<std::vector<int32_t>, int, VecHash> leaf_cache;

    auto run_leaf_filter = [&](const std::vector<int32_t> &a_to_b) -> bool {
        if (!leaf_filter) return true;
        auto it = leaf_cache.find(a_to_b);
        if (it != leaf_cache.end()) return it->second != 0;
        int ok = leaf_filter(a_to_b.data(), n_a);
        leaf_cache.emplace(a_to_b, ok);
        return ok != 0;
    };

    std::vector<Search::Node *> children;
    while (!queue.empty()) {
        Search::Node *node = queue.top();
        queue.pop();
        nodes_visited++;
        bool is_leaf = node->layer == n_a;

        if (is_leaf) {
            bool any = false;
            for (int b : node->a_to_b)
                if (b != UNMAPPED) any = true;
            if (any) {
                if (run_leaf_filter(node->a_to_b)) {
                    if (n_maps < max_cores) {
                        std::memcpy(out_maps + (size_t)n_maps * n_a, node->a_to_b.data(), sizeof(int32_t) * n_a);
                        n_maps++;
                    }
                }
                leaves_visited++;
                if (leaves_visited == max_cores) {
                    timed_out = true;
                    delete node;
                    break;
                }
            }
        } else if (node->bound >= best_num_edges) {
            children.clear();
            int v_a = node->layer;
            for (int v_b : priority[v_a]) {
                if (node->b_to_a[v_b] != UNMAPPED) continue;
                auto child = new Search::Node();
                child->a_to_b = node->a_to_b;
                child->b_to_a = node->b_to_a;
                child->a_to_b[v_a] = v_b;
                child->b_to_a[v_b] = v_a;
                if (enforce_core_core && !S.core_preserves_edges(v_a, v_b, child->a_to_b, child->b_to_a)) {
                    delete child;
                    continue;
                }
                S.refine(node->marcs, child->marcs, v_a, v_b);
                child->layer = v_a + 1;
                child->seq = seq_counter++;
                child->bound = S.arcs_left(child->marcs);
                children.push_back(child);
            }
            {
                auto child = new Search::Node();
                child->a_to_b = node->a_to_b;
                child->b_to_a = node->b_to_a;
                S.refine(node->marcs, child->marcs, v_a, UNMAPPED);
                child->layer = v_a + 1;
                child->seq = seq_counter++;
                child->bound = S.arcs_left(child->marcs);
                children.push_back(child);
            }

            for (auto child : children) {
                if (child->bound < best_num_edges) {
                    delete child;
                    continue;
                }
                if (!S.cc_ok(*child)) {
                    delete child;
                    continue;
                }
                if (!passes_builtin_filters(child->a_to_b)) {
                    delete child;
                    continue;
                }
                if (filter && !filter(child->a_to_b.data(), n_a)) {
                    delete child;
                    continue;
                }
                if (child->layer == n_a && run_leaf_filter(child->a_to_b)) {
                    if (child->bound > best_num_edges) best_num_edges = child->bound;
                }
                queue.push(child);
            }
        }

        delete node;

        if (nodes_visited == max_visits) {
            timed_out = true;
            break;
        }
    }

    while (!queue.empty()) {
        delete queue.top();
        queue.pop();
    }

    *out_n_maps = n_maps;
    *out_nodes_visited = nodes_visited;
    *out_leaves_visited = leaves_visited;
    *out_timed_out = timed_out ? 1 : 0;

    if (n_maps == 0) return timed_out ? 2 : 3;
    return 0;
}
}
