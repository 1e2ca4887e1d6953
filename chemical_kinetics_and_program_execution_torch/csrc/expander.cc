// Native window-sweep expander: a host library, not a CUDA kernel.
//
// The port's copy of the JAX package's native/expander.cc; built by
// `engine/native.py` with g++ into `_build/` at first use (its name is
// not `*.cu`, so `cuda.py`'s nvcc build leaves it out).
//
// C++ twin of engine/accumulate.py (itself the compile-time port of the
// reference's fast accumulation recursion `lr-rec-extend-1`,
// tape_multiverse.scm:1249-1401). Expands each terminal world-signature
// (i_orig, i_adj, length) into accumulation events
//   (signature id, target_orig, target_adj, [(num_idx, den_idx) ...])
// over the flat marginal-pyramid index space.
//
// This is the hot half of problem compilation: the big problems expand
// into 10^7+ events (ex4 at cl_k=5: ~1.2e7), which takes minutes in
// Python and well under a second here. Event ORDER is bit-identical to
// the Python expander so compiled tables are interchangeable and
// cacheable across implementations.
//
// Exposed as a tiny C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <vector>

namespace {

struct Events {
  std::vector<int32_t> sig;      // per event: signature id
  std::vector<int64_t> tgt_orig; // per event: original window rank
  std::vector<int64_t> tgt_adj;  // per event: adjusted window rank
  std::vector<int64_t> chain_start; // per event: offset into pairs
  std::vector<int32_t> num;      // flat factor-chain numerator indices
  std::vector<int32_t> den;      // flat factor-chain denominator indices
};

class Expander {
 public:
  Expander(int64_t size_a, int64_t cl_k)
      : a_(size_a), cl_k_(cl_k) {
    window_mod_ = 1;
    for (int64_t j = 0; j < cl_k; ++j) window_mod_ *= a_;
    prefix_mod_ = window_mod_ / a_;
    // Pyramid level offsets: level j (length-j marginal table) lives at
    // offsets_[j]; levels are laid out cl_k, cl_k-1, ..., 0, then one
    // constant-1 padding slot (markov.pyramid_offsets).
    offsets_.resize(cl_k + 1);
    int64_t pos = 0;
    int64_t level_size = window_mod_;
    for (int64_t j = cl_k; j >= 0; --j) {
      offsets_[j] = pos;
      pos += level_size;
      level_size /= a_;
    }
  }

  // Expands one signature, appending to ev with the given signature id.
  void Expand(Events* ev, int32_t sig_id, int64_t i_orig, int64_t i_adj,
              int64_t length) {
    ev_ = ev;
    sig_id_ = sig_id;
    chain_.clear();
    ExtendLe(i_orig, i_adj, length, length >= cl_k_ - 1);
  }

 private:
  void PushRatio(int64_t idx_long, int64_t len_long, int64_t idx_short,
                 int64_t len_short) {
    chain_.push_back(
        {static_cast<int32_t>(offsets_[len_long] + idx_long),
         static_cast<int32_t>(offsets_[len_short] + idx_short)});
  }

  void Emit(int64_t io, int64_t ia) {
    int64_t o = io % window_mod_;
    int64_t adj = ia % window_mod_;
    if (o == adj) return;
    ev_->sig.push_back(sig_id_);
    ev_->tgt_orig.push_back(o);
    ev_->tgt_adj.push_back(adj);
    ev_->chain_start.push_back(static_cast<int64_t>(ev_->num.size()));
    for (const auto& p : chain_) {
      ev_->num.push_back(p.first);
      ev_->den.push_back(p.second);
    }
    // chain end is implied by the next event's chain_start (or the
    // total length for the last event); store a sentinel via lengths
    // derived host-side.
    chain_lens_.push_back(static_cast<int64_t>(chain_.size()));
    ev_->chain_start.back() = chain_lens_.back();  // store LENGTH here
  }

  void ExtendLe(int64_t io, int64_t ia, int64_t ln, bool do_right) {
    if (io == ia) return;
    if (ln < cl_k_) {
      int64_t place = 1;
      for (int64_t j = 0; j < ln; ++j) place *= a_;
      for (int64_t s = 0; s < a_; ++s) {
        int64_t sc = s * place;
        PushRatio(io + sc, ln + 1, io, ln);
        ExtendLe(io + sc, ia + sc, ln + 1, ln + 1 == cl_k_ - 1);
        chain_.pop_back();
      }
    } else if (ln == cl_k_) {
      Emit(io, ia);
      int64_t suf_o = io / a_, suf_a = ia / a_;
      int64_t place = 1;
      for (int64_t j = 0; j < ln - 1; ++j) place *= a_;
      for (int64_t s = 0; s < a_; ++s) {
        int64_t sc = s * place;
        PushRatio(sc + suf_o, ln, suf_o, ln - 1);
        ExtendLe(sc + suf_o, sc + suf_a, ln, false);
        chain_.pop_back();
      }
    } else {
      Emit(io, ia);
      ExtendLe(io / a_, ia / a_, ln - 1, false);
    }
    if (do_right) {
      ExtendRi(io % prefix_mod_, ia % prefix_mod_);
    }
  }

  void ExtendRi(int64_t po, int64_t pa) {
    if (po == pa) return;
    for (int64_t s = 0; s < a_; ++s) {
      int64_t io = po * a_ + s, ia = pa * a_ + s;
      PushRatio(io, cl_k_, po, cl_k_ - 1);
      Emit(io, ia);
      ExtendRi(io % prefix_mod_, ia % prefix_mod_);
      chain_.pop_back();
    }
  }

  int64_t a_, cl_k_, window_mod_, prefix_mod_;
  std::vector<int64_t> offsets_;
  std::vector<std::pair<int32_t, int32_t>> chain_;
  std::vector<int64_t> chain_lens_;
  Events* ev_ = nullptr;
  int32_t sig_id_ = 0;
};

}  // namespace

extern "C" {

// Expands K signatures (flat [K*3] array of i_orig, i_adj, length).
// Returns an opaque handle; query + fill + free below.
void* ckpe_expand(int64_t size_a, int64_t cl_k, int64_t num_sigs,
                  const int64_t* sigs) {
  auto* ev = new Events();
  Expander ex(size_a, cl_k);
  for (int64_t k = 0; k < num_sigs; ++k) {
    ex.Expand(ev, static_cast<int32_t>(k), sigs[3 * k], sigs[3 * k + 1],
              sigs[3 * k + 2]);
  }
  return ev;
}

int64_t ckpe_num_events(void* handle) {
  return static_cast<int64_t>(static_cast<Events*>(handle)->sig.size());
}

int64_t ckpe_max_chain(void* handle) {
  auto* ev = static_cast<Events*>(handle);
  int64_t m = 0;
  for (int64_t len : ev->chain_start) m = len > m ? len : m;
  return m;
}

// Fills caller-allocated buffers:
//   e_num, e_den: [num_events * max_chain] int32, pre-filled by the
//     caller with the padding slot index (constant-1 pyramid entry);
//   e_sig: [num_events] int32; tgt_orig / tgt_adj: [num_events] int64.
void ckpe_fill(void* handle, int64_t max_chain, int32_t* e_num,
               int32_t* e_den, int32_t* e_sig, int64_t* tgt_orig,
               int64_t* tgt_adj) {
  auto* ev = static_cast<Events*>(handle);
  const int64_t n = static_cast<int64_t>(ev->sig.size());
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    e_sig[i] = ev->sig[i];
    tgt_orig[i] = ev->tgt_orig[i];
    tgt_adj[i] = ev->tgt_adj[i];
    const int64_t len = ev->chain_start[i];  // stores chain LENGTH
    for (int64_t j = 0; j < len; ++j) {
      e_num[i * max_chain + j] = ev->num[pos];
      e_den[i * max_chain + j] = ev->den[pos];
      ++pos;
    }
  }
}

void ckpe_free(void* handle) { delete static_cast<Events*>(handle); }

}  // extern "C"
