// Native guided multiverse enumeration for the ex6 mini-BFF rule: a host
// library, not a CUDA kernel.
//
// The port's copy of the repository's native/enumerate6.cc; built by
// `engine/native.py` with g++ into `_build/` at first use (its name is
// not `*.cu`, so `cuda.py`'s nvcc build leaves it out).
//
// C++ twin of engine/enumerate.py for the one registered problem whose
// faithful parameters (fuel 10, data heads 12 apart) make the decision
// tree astronomically branchy: threshold-guided enumeration
// (BeamGuide semantics) explores millions of tree nodes, and the Python
// odometer pays a full rule re-execution per node (~30 us each). Here
// the rule is a flat-register tail-recursive machine, so the tree walks
// as a TRUE depth-first recursion with backtracking — no re-execution —
// at ~100 ns per node.
//
// Exactness contract: the emitted world sequence (factor chains, tape
// signatures, DFS order) is bit-identical to
// `enumerate.enumerate_worlds(problem, cl_k, guide=BeamGuide(...))`
// for the ex6 rules (`models/problems.py:_ex6_rule`); the parity test
// lives in tests/test_torch_pruned.py. The rule has no `choose` nodes, so
// every world's const is exactly 1 and only reveal factors are tracked.
//
// Same build/ABI pattern as expander.cc: ctypes C ABI, no pybind11.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxSpan = 40;     // revealed cells per tape (fuel-bounded)
// Signatures are unsigned 128-bit (returned as hi/lo int64 pairs and
// reassembled into Python bignums): 12^35 < 2^128 covers every
// fuel<=20 span; deeper spans flag overflow -> the Python odometer.
constexpr int kSigSpanLimit = 35;

struct Tape {
  int l_len = 0, r_len = 0;
  // Cell index i lives at buf[kMaxSpan + i].
  int8_t orig[2 * kMaxSpan];
  int8_t adj[2 * kMaxSpan];

  bool covers(int idx) const { return -l_len <= idx && idx < r_len; }
  int value(int idx) const { return adj[kMaxSpan + idx]; }
};

struct Worlds {
  std::vector<int32_t> chain_len;  // per world
  std::vector<int32_t> num, den;   // flat factor chains
  std::vector<int64_t> sigs;       // per world, per tape: io_hi, io_lo,
                                   // ia_hi, ia_lo, len  (10 entries)
  bool overflow = false;           // signature span exceeded int64
  bool too_many = false;           // exceeded max_worlds
};

class Enum6 {
 public:
  Enum6(int64_t size_a, int64_t cl_k, int64_t fuel, int64_t d1_start,
        double threshold, const double* pyr, int64_t max_worlds,
        int64_t code_tape, Worlds* out)
      : a_(static_cast<int>(size_a)), cl_k_(static_cast<int>(cl_k)),
        fuel_(static_cast<int>(fuel)),
        d1_start_(static_cast<int>(d1_start)),
        code_tape_(static_cast<int>(code_tape)), thr_(threshold),
        pyr_(pyr), max_worlds_(max_worlds), out_(out) {
    offsets_.resize(cl_k + 2);
    int64_t pos = 0;
    int64_t level_size = 1;
    for (int64_t j = 0; j < cl_k; ++j) level_size *= a_;
    for (int64_t j = cl_k; j >= 0; --j) {
      offsets_[j] = pos;
      pos += level_size;
      level_size /= a_;
    }
    weight_ = 1.0;
  }

  void Run() { Loop(fuel_, 0, 0, d1_start_, 0); }

 private:
  // --- tape access: mirrors enumerate._Replay._reveal / tape_get / tape_set.
  // Get with branching: calls cont(value) for every surviving symbol
  // of every unrevealed cell on the way to `idx` (depth-first,
  // symbol-ascending — the Python odometer's order).
  template <typename Cont>
  void Get(int tp, int idx, Cont&& cont) {
    if (stop()) return;
    Tape& t = tapes_[tp];
    if (t.covers(idx)) {
      cont(t.value(idx));
      return;
    }
    const bool to_right = idx >= 0;
    const int visible = t.l_len + t.r_len;
    const int cl_eff = std::min(cl_k_, visible + 1);
    const int ctx_len = cl_eff - 1;
    int64_t ctx = 0;
    if (ctx_len) {
      // Context over ORIGINAL content: last ctx_len symbols for a right
      // reveal, first ctx_len for a left reveal.
      const int base = to_right ? t.r_len - ctx_len : -t.l_len;
      for (int j = 0; j < ctx_len; ++j) {
        ctx = ctx * a_ + t.orig[kMaxSpan + base + j];
      }
    }
    int64_t pctx = 1;
    for (int j = 0; j < ctx_len; ++j) pctx *= a_;
    const int32_t den = static_cast<int32_t>(offsets_[ctx_len] + ctx);
    for (int s = 0; s < a_; ++s) {
      const int64_t win = to_right ? ctx * a_ + s : s * pctx + ctx;
      const int32_t num = static_cast<int32_t>(offsets_[cl_eff] + win);
      const double p_num = pyr_[num];
      const double ratio =
          p_num > 0.0 ? p_num / std::max(p_num, pyr_[den]) : 0.0;
      const double w2 = weight_ * ratio;
      if (w2 < thr_) continue;  // BeamGuide prune: strict <
      // Push: factor, weight, one revealed cell.
      factors_.push_back({num, den});
      const double w_save = weight_;
      weight_ = w2;
      if (to_right) {
        t.orig[kMaxSpan + t.r_len] = static_cast<int8_t>(s);
        t.adj[kMaxSpan + t.r_len] = static_cast<int8_t>(s);
        ++t.r_len;
      } else {
        ++t.l_len;
        t.orig[kMaxSpan - t.l_len] = static_cast<int8_t>(s);
        t.adj[kMaxSpan - t.l_len] = static_cast<int8_t>(s);
      }
      Get(tp, idx, cont);  // may reveal further cells, then continue
      // Pop.
      if (to_right) {
        --t.r_len;
      } else {
        --t.l_len;
      }
      weight_ = w_save;
      factors_.pop_back();
      if (stop()) return;
    }
  }

  template <typename Cont>
  void Set(int tp, int idx, int v, Cont&& cont) {
    Get(tp, idx, [this, tp, idx, v, &cont](int) {
      Tape& t = tapes_[tp];
      const int8_t old = t.adj[kMaxSpan + idx];
      t.adj[kMaxSpan + idx] = static_cast<int8_t>(v);
      cont();
      t.adj[kMaxSpan + idx] = old;
    });
  }

  bool stop() const { return out_->overflow || out_->too_many; }

  void Emit() {
    if (stop()) return;
    // Python parity: error raised when the world COUNT exceeds
    // max_worlds (checked after appending).
    if (max_worlds_ >= 0 &&
        static_cast<int64_t>(out_->chain_len.size()) + 1 > max_worlds_) {
      out_->too_many = true;
      return;
    }
    out_->chain_len.push_back(static_cast<int32_t>(factors_.size()));
    for (const auto& f : factors_) {
      out_->num.push_back(f.first);
      out_->den.push_back(f.second);
    }
    for (const Tape& t : tapes_) {
      const int len = t.l_len + t.r_len;
      if (len > kSigSpanLimit) {
        out_->overflow = true;
        return;
      }
      unsigned __int128 io = 0, ia = 0;
      for (int j = -t.l_len; j < t.r_len; ++j) {
        io = io * a_ + t.orig[kMaxSpan + j];
        ia = ia * a_ + t.adj[kMaxSpan + j];
      }
      out_->sigs.push_back(static_cast<int64_t>(io >> 64));
      out_->sigs.push_back(static_cast<int64_t>(
          io & 0xffffffffffffffffULL));
      out_->sigs.push_back(static_cast<int64_t>(ia >> 64));
      out_->sigs.push_back(static_cast<int64_t>(
          ia & 0xffffffffffffffffULL));
      out_->sigs.push_back(len);
    }
  }

  // --- the ex6 mini-BFF rule (models/problems.py:_ex6_rule), CPS form.
  // Symbols: 0 lt, 1 gt, 2 cl, 3 cr, 4 minus, 5 plus, 6 dot, 7 comma,
  //          8 bl, 9 br, 10 zero, 11 nop.
  // `code_tape_` is 0 for the two-tape rule and 1 for the single-tape
  // SELF-MODIFYING variants (`code_tape=DATA` in problems.py): the
  // opcode fetch then reads the live data ring — Get returns the
  // ADJUSTED value for covered cells, so writes landing in the
  // instruction stream are fetched back (live-fetch semantics,
  // matching `_Replay.tape_get`).
  void Loop(int budget, int p, int d0, int d1, int scan) {
    if (stop()) return;
    if (budget == 0) {
      Emit();
      return;
    }
    Get(code_tape_, p, [=](int op) {
      if (scan < 0) {  // looking left for the (-scan)-th '['
        if (op == 8) {
          if (scan == -1) Loop(budget - 1, p + 1, d0, d1, 0);
          else Loop(budget - 1, p - 1, d0, d1, scan + 1);
        } else if (op == 9) {
          Loop(budget - 1, p - 1, d0, d1, scan - 1);
        } else {
          Loop(budget - 1, p - 1, d0, d1, scan);
        }
      } else if (scan > 0) {  // looking right for the scan-th ']'
        if (op == 9) {
          if (scan == 1) Loop(budget - 1, p + 1, d0, d1, 0);
          else Loop(budget - 1, p + 1, d0, d1, scan - 1);
        } else if (op == 8) {
          Loop(budget - 1, p + 1, d0, d1, scan + 1);
        } else {
          Loop(budget - 1, p + 1, d0, d1, scan);
        }
      } else if (op == 0 || op == 1) {  // lt / gt
        Loop(budget - 1, p + 1, d0 + (op == 0 ? -1 : 1), d1, 0);
      } else if (op == 2 || op == 3) {  // cl / cr
        Loop(budget - 1, p + 1, d0, d1 + (op == 2 ? -1 : 1), 0);
      } else if (op == 4 || op == 5) {  // minus / plus
        Get(1, d0, [=](int v) {
          const int nv = ((v + (op == 5 ? 1 : -1)) % a_ + a_) % a_;
          Set(1, d0, nv, [=]() { Loop(budget - 1, p + 1, d0, d1, 0); });
        });
      } else if (op == 6) {  // dot: d1 <- d0
        Get(1, d0, [=](int v) {
          Set(1, d1, v, [=]() { Loop(budget - 1, p + 1, d0, d1, 0); });
        });
      } else if (op == 7) {  // comma: d0 <- d1
        Get(1, d1, [=](int v) {
          Set(1, d0, v, [=]() { Loop(budget - 1, p + 1, d0, d1, 0); });
        });
      } else if (op == 8) {  // bl
        Get(1, d0, [=](int v) {
          Loop(budget - 1, p + 1, d0, d1, v == 10 ? 1 : 0);
        });
      } else if (op == 9) {  // br
        Get(1, d0, [=](int v) {
          if (v == 10) Loop(budget - 1, p + 1, d0, d1, 0);
          else Loop(budget - 1, p - 1, d0, d1, -1);
        });
      } else {  // zero / nop
        Loop(budget - 1, p + 1, d0, d1, 0);
      }
    });
  }

  const int a_, cl_k_, fuel_, d1_start_, code_tape_;
  const double thr_;
  const double* pyr_;
  const int64_t max_worlds_;
  Worlds* out_;
  std::vector<int64_t> offsets_;
  Tape tapes_[2];
  std::vector<std::pair<int32_t, int32_t>> factors_;
  double weight_;
};

}  // namespace

extern "C" {

// Library ABI version (v2: ckpe_enum6 gained the code_tape parameter).
// The port names its library by a hash of this source, so a stale build
// is never loaded; `engine/native.py` checks the version all the same.
int64_t ckpe_abi_version(void) { return 2; }

// Guided enumeration of the ex6 rule. Returns an opaque handle.
// max_worlds < 0 disables the bound. code_tape: 0 = two-tape rule,
// 1 = single-tape self-modifying variant (op fetch on the data ring).
void* ckpe_enum6(int64_t size_a, int64_t cl_k, int64_t fuel,
                 int64_t d1_start, double threshold, const double* pyr,
                 int64_t max_worlds, int64_t code_tape) {
  auto* w = new Worlds();
  Enum6 e(size_a, cl_k, fuel, d1_start, threshold, pyr, max_worlds,
          code_tape, w);
  e.Run();
  return w;
}

int64_t ckpe_enum6_num_worlds(void* handle) {
  return static_cast<int64_t>(
      static_cast<Worlds*>(handle)->chain_len.size());
}

int64_t ckpe_enum6_num_factors(void* handle) {
  return static_cast<int64_t>(static_cast<Worlds*>(handle)->num.size());
}

// 1 = signature span exceeded 128-bit range; 2 = max_worlds exceeded.
int64_t ckpe_enum6_status(void* handle) {
  auto* w = static_cast<Worlds*>(handle);
  return w->overflow ? 1 : (w->too_many ? 2 : 0);
}

void ckpe_enum6_fill(void* handle, int32_t* chain_len, int32_t* num,
                     int32_t* den, int64_t* sigs) {
  auto* w = static_cast<Worlds*>(handle);
  std::copy(w->chain_len.begin(), w->chain_len.end(), chain_len);
  std::copy(w->num.begin(), w->num.end(), num);
  std::copy(w->den.begin(), w->den.end(), den);
  std::copy(w->sigs.begin(), w->sigs.end(), sigs);
}

void ckpe_enum6_free(void* handle) {
  delete static_cast<Worlds*>(handle);
}

}  // extern "C"
