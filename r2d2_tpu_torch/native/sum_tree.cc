// Host-side priority sum tree of the host-placement replay
// (r2d2_tpu_torch/replay/host_replay.py): float64 nodes, p = |td|^alpha
// with p(0) = 0, a stratified prefix-sum descent that never enters a
// zero-mass right subtree, and IS weights (p / min_p)^-beta. Given the
// same stratified jitter it samples what ops/sum_tree.py's numpy twin
// does.
//
// C ABI for ctypes (native/__init__.py builds it with g++). One tree is
// single-threaded: the host replay serializes every call under its lock.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct SumTree {
  int64_t num_layers;
  int64_t capacity;           // leaves
  std::vector<double> nodes;  // 2^num_layers - 1
};

int64_t layers_for(int64_t capacity) {
  int64_t layers = 1;
  while (capacity > (int64_t(1) << (layers - 1))) ++layers;
  return layers;
}

}  // namespace

extern "C" {

SumTree* st_create(int64_t capacity) {
  auto* t = new SumTree;
  t->num_layers = layers_for(capacity);
  t->capacity = capacity;
  t->nodes.assign((int64_t(1) << t->num_layers) - 1, 0.0);
  return t;
}

void st_destroy(SumTree* t) { delete t; }

int64_t st_num_layers(const SumTree* t) { return t->num_layers; }

double st_total(const SumTree* t) { return t->nodes[0]; }

// Write p = |td|^alpha at the given leaves and carry each change up to the
// root, one leaf at a time (n is at most a batch or a block of sequences).
void st_update(SumTree* t, double alpha, const double* td_errors,
               const int64_t* idxes, int64_t n) {
  const int64_t leaf0 = (int64_t(1) << (t->num_layers - 1)) - 1;
  for (int64_t i = 0; i < n; ++i) {
    const double td = td_errors[i];
    const double p = td != 0.0 ? std::pow(std::fabs(td), alpha) : 0.0;
    int64_t node = leaf0 + idxes[i];
    const double delta = p - t->nodes[node];
    t->nodes[node] = p;
    while (node != 0) {
      node = (node - 1) / 2;
      t->nodes[node] += delta;
    }
  }
}

// Stratified proportional sampling: jitter[i] in [0, 1) is stratum i's
// uniform draw, from the caller's generator. Writes leaf indices and IS
// weights (p / min_p)^-beta.
void st_sample(const SumTree* t, double beta, int64_t n, const double* jitter,
               int64_t* out_idxes, double* out_weights) {
  const int64_t leaf0 = (int64_t(1) << (t->num_layers - 1)) - 1;
  const double p_sum = t->nodes[0];
  const double interval = p_sum / static_cast<double>(n);
  double min_p = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double prefix = (static_cast<double>(i) + jitter[i]) * interval;
    if (prefix > p_sum * (1.0 - 1e-12)) prefix = p_sum * (1.0 - 1e-12);
    int64_t node = 0;
    for (int64_t layer = 0; layer < t->num_layers - 1; ++layer) {
      const double left = t->nodes[2 * node + 1];
      const double right = t->nodes[2 * node + 2];
      if (prefix < left || right <= 0.0) {
        node = 2 * node + 1;
        const double cap = left * (1.0 - 1e-12);
        if (prefix > cap) prefix = cap;
      } else {
        node = 2 * node + 2;
        prefix -= left;
      }
    }
    const double p = t->nodes[node];
    out_idxes[i] = node - leaf0;
    out_weights[i] = p;
    if (i == 0 || p < min_p) min_p = p;
  }
  for (int64_t i = 0; i < n; ++i) {
    out_weights[i] = std::pow(out_weights[i] / min_p, -beta);
  }
}

}  // extern "C"
