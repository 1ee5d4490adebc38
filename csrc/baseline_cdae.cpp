// Faithful CPU reproduction of the reference CDAE training loop, used to
// MEASURE the performance baseline and to provide METRIC-PARITY evidence
// (the reference repo publishes no numbers and its binary needs Eigen/Boost,
// absent here; see BASELINE.md). Mirrors
// /root/reference/src/model/recsys/cdae.hpp semantics re-implemented from
// scratch:
//   - per-user sequential SGD, one corruption per user per epoch
//     (cdae.hpp:136-146)
//   - Bernoulli mask-out corruption kept w.p. (1-q), scaled 1/(1-q)
//     (cdae.hpp:361-371, 202-205)
//   - hidden z = sigmoid(scale*sum W[kept] + b + Wu[u]) with +-18 clamps
//     (cdae.hpp:373-416)
//   - per-positive and per-negative (num_neg*|O_u| rejection-sampled)
//     AdaGrad updates of b', W rows; hidden-gradient accumulation;
//     b / Wu / input-row updates (cdae.hpp:198-358)
//   - recommend: uncorrupted hidden state, full-catalog scan, top-10
//     excluding rated (cdae.hpp:162-196)
// Plain float arrays (no Eigen temporaries) => a conservative (fast)
// stand-in for the reference's throughput.
//
// Modes:
//   baseline_cdae bench  [U I avg_degree dim seconds]
//   baseline_cdae parity train.txt test.txt [iters dim cratio num_neg lr]
// Each prints one JSON line.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <random>
#include <string>
#include <type_traits>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

std::mt19937_64 g_rng(20141119);

inline float sigmoid_clamped(float x) {
  if (x > 18.f) return 1.f;
  if (x < -18.f) return 0.f;
  return 1.f / (1.f + std::exp(-x));
}

inline float tanh_clamped(float x) {  // ref cdae.hpp:404-412
  if (x > 9.f) return 1.f;
  if (x < -9.f) return -1.f;
  float r = std::exp(-2.f * x);
  return (1.f - r) / (1.f + r);
}

// Variant switches of the reference CDAEConfig (cdae.hpp:13-31) that change
// the update math; covers the canonical sweep (apps/yelp/cdae.sh:3-25).
struct CDAEVariant {
  int loss = 0;           // 0 = SQUARE, 1 = CE (ref loss.hpp:38-74,121-160)
  bool asymmetric = false;       // decoder V (ref cdae.hpp:241-246)
  bool user_factor = true;       // Wu (ref cdae.hpp:295-299)
  bool linear = false;           // identity activation (ref cdae.hpp:391)
  bool tanh = false;             // tanh activation (ref cdae.hpp:404-412)
  bool linear_function = false;  // per-user gate Uu (ref cdae.hpp:382-384)
};

struct CDAEModel {
  size_t U, I, D;
  float lr, lambda, beta, cratio, scale;
  int num_neg;
  CDAEVariant var;
  std::vector<float> W, W_ag, V, V_ag, Wu, Wu_ag, Uu, Uu_ag, b, b_ag, bp,
      bp_ag;

  CDAEModel(size_t U_, size_t I_, size_t D_, float lr_, float lambda_,
            float beta_, float cratio_, int num_neg_, bool scaled,
            CDAEVariant var_ = CDAEVariant())
      : U(U_), I(I_), D(D_), lr(lr_), lambda(lambda_), beta(beta_),
        cratio(cratio_),
        scale(scaled && cratio_ < 1.f ? 1.f / (1.f - cratio_) : 1.f),
        num_neg(num_neg_), var(var_), W(I * D), W_ag(I * D, 1e-4f),
        b(D, 0.f), b_ag(D, 1e-4f), bp(I, 0.f), bp_ag(I, 1e-4f) {
    float init = 4.f * std::sqrt(6.f / (float)(I + D));
    std::uniform_real_distribution<float> winit(-init, init);
    for (auto& w : W) w = winit(g_rng);
    if (var.asymmetric) {
      V.assign(I * D, 0.f);
      V_ag.assign(I * D, 1e-4f);
      for (auto& w : V) w = winit(g_rng);
    }
    if (var.user_factor) {
      Wu.assign(U * D, 0.f);
      Wu_ag.assign(U * D, 1e-4f);
      for (auto& w : Wu) w = winit(g_rng);
    }
    if (var.linear_function) {
      Uu.assign(U * D, 1.f);  // init to ones (ref cdae.hpp:131-133)
      Uu_ag.assign(U * D, 1e-4f);
    }
  }

  // loss gradient dl/dpred at the given truth label
  inline float loss_grad(float pred, float truth) const {
    if (var.loss == 1) {  // CE (ref loss.hpp:141-147)
      if (pred < -18.f) return std::exp(pred) - truth;
      if (pred > 18.f) return 1.f - truth;
      return 1.f / (1.f + std::exp(-pred)) - truth;
    }
    return -2.f * (truth - pred);  // SQUARE
  }

  // h = act(gate?(Uu ⊙ Σ W[kept]·scale) + b + Wu) (ref cdae.hpp:373-416)
  void hidden(size_t u, const std::vector<int>& in_items, float in_scale,
              std::vector<float>& z) const {
    for (size_t k = 0; k < D; ++k) z[k] = 0.f;
    for (int it : in_items)
      for (size_t k = 0; k < D; ++k)
        z[k] += in_scale * W[(size_t)it * D + k];
    if (var.linear_function)
      for (size_t k = 0; k < D; ++k) z[k] *= Uu[u * D + k];
    for (size_t k = 0; k < D; ++k) z[k] += b[k];
    if (var.user_factor)
      for (size_t k = 0; k < D; ++k) z[k] += Wu[u * D + k];
    if (!var.linear) {
      if (!var.tanh)
        for (size_t k = 0; k < D; ++k) z[k] = sigmoid_clamped(z[k]);
      else
        for (size_t k = 0; k < D; ++k) z[k] = tanh_clamped(z[k]);
    }
  }

  void train_one_user(size_t u, const std::vector<int>& items) {
    std::uniform_real_distribution<float> unif(0.f, 1.f);
    std::uniform_int_distribution<size_t> item_dist(0, I - 1);
    std::unordered_set<int> item_set(items.begin(), items.end());
    std::vector<int> kept_ids;
    std::unordered_set<int> kept_set;
    for (int it : items)
      if (unif(g_rng) > cratio) {
        kept_ids.push_back(it);
        kept_set.insert(it);
      }
    std::vector<float> z(D), hg(D, 0.f);
    hidden(u, kept_ids, scale, z);
    // deferred decode-side gradients of positives that survived corruption
    // (ref cdae.hpp:241-246: folded into the input-row update, no lambda
    // term of their own, single AdaGrad touch)
    std::vector<float> deferred;   // packed per kept positive, D floats
    std::vector<int> deferred_id;

    auto touch_output = [&](int o, float truth) {
      float* dec = var.asymmetric ? &V[(size_t)o * D] : &W[(size_t)o * D];
      float* dec_ag =
          var.asymmetric ? &V_ag[(size_t)o * D] : &W_ag[(size_t)o * D];
      float pred = bp[o];
      for (size_t k = 0; k < D; ++k) pred += dec[k] * z[k];
      float g = loss_grad(pred, truth);
      float gb = g + lambda * bp[o];
      bp_ag[o] += gb * gb;
      bp[o] -= lr * gb / (beta + std::sqrt(bp_ag[o]));
      for (size_t k = 0; k < D; ++k) hg[k] += g * dec[k];
      if (!var.asymmetric && truth > 0.f && kept_set.count(o)) {
        // positive still in the input set: defer g·z to the input-row pass
        deferred_id.push_back(o);
        for (size_t k = 0; k < D; ++k) deferred.push_back(g * z[k]);
        return;
      }
      for (size_t k = 0; k < D; ++k) {
        float gw = g * z[k] + lambda * dec[k];
        dec_ag[k] += gw * gw;
        dec[k] -= lr * gw / (beta + std::sqrt(dec_ag[k]));
      }
    };

    for (int o : items) touch_output(o, 1.f);
    size_t nneg = (size_t)num_neg * items.size();
    for (size_t s = 0; s < nneg; ++s) {
      int j;
      do { j = (int)item_dist(g_rng); } while (item_set.count(j));
      touch_output(j, 0.f);
    }
    // z' factor (ref cdae.hpp:207-215): sigmoid z-z², tanh 1-z², linear 1
    if (!var.linear) {
      if (!var.tanh)
        for (size_t k = 0; k < D; ++k) hg[k] *= z[k] * (1.f - z[k]);
      else
        for (size_t k = 0; k < D; ++k) hg[k] *= 1.f - z[k] * z[k];
    }
    for (size_t k = 0; k < D; ++k) {
      float gb = hg[k] + lambda * b[k];
      b_ag[k] += gb * gb;
      b[k] -= lr * gb / (beta + std::sqrt(b_ag[k]));
    }
    if (var.user_factor) {
      for (size_t k = 0; k < D; ++k) {
        float gu = hg[k] + lambda * Wu[u * D + k];
        Wu_ag[u * D + k] += gu * gu;
        Wu[u * D + k] -= lr * gu / (beta + std::sqrt(Wu_ag[u * D + k]));
      }
    }
    // input-row updates; the Uu gradient accumulates hg⊙z'⊙W_j with NO
    // scale factor (reference quirk, cdae.hpp:340-346)
    std::vector<float> uu_grad;
    if (var.linear_function) {
      uu_grad.assign(D, 0.f);
      for (size_t k = 0; k < D; ++k)
        uu_grad[k] = lambda * Uu[u * D + k];
    }
    size_t di = 0;
    for (size_t ii = 0; ii < kept_ids.size(); ++ii) {
      int it = kept_ids[ii];
      float* wi = &W[(size_t)it * D];
      float* wag = &W_ag[(size_t)it * D];
      const float* extra = nullptr;
      if (!var.asymmetric && di < deferred_id.size() &&
          deferred_id[di] == it)
        extra = &deferred[(size_t)di * D];
      for (size_t k = 0; k < D; ++k) {
        float enc = hg[k];
        if (var.linear_function) {
          uu_grad[k] += hg[k] * wi[k];
          enc *= Uu[u * D + k];
        }
        float gw = enc * scale + lambda * wi[k];
        if (extra) gw += extra[k];
        wag[k] += gw * gw;
        wi[k] -= lr * gw / (beta + std::sqrt(wag[k]));
      }
      if (extra) ++di;
    }
    if (var.linear_function) {
      for (size_t k = 0; k < D; ++k) {
        Uu_ag[u * D + k] += uu_grad[k] * uu_grad[k];
        Uu[u * D + k] -=
            lr * uu_grad[k] / (beta + std::sqrt(Uu_ag[u * D + k]));
      }
    }
  }

  // top-10 unrated items (heap-free partial sort; same result as the
  // reference bounded heap, cdae.hpp:162-196)
  std::vector<int> recommend(size_t u, const std::vector<int>& rated,
                             size_t topk) const {
    std::vector<float> z(D);
    // UNcorrupted input, scale 1; ratio==1 scores from an empty input set
    // (ref cdae.hpp:168-172)
    static const std::vector<int> kEmpty;
    hidden(u, cratio == 1.f ? kEmpty : rated, 1.f, z);
    std::unordered_set<int> rated_set(rated.begin(), rated.end());
    const std::vector<float>& dec = var.asymmetric ? V : W;
    std::vector<std::pair<float, int>> cand;
    cand.reserve(I);
    for (size_t i = 0; i < I; ++i) {
      if (rated_set.count((int)i)) continue;
      const float* wi = &dec[i * D];
      float pred = bp[i];
      for (size_t k = 0; k < D; ++k) pred += wi[k] * z[k];
      cand.push_back({pred, (int)i});
    }
    size_t k = std::min(topk, cand.size());
    std::partial_sort(cand.begin(), cand.begin() + (long)k, cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    std::vector<int> out(k);
    for (size_t j = 0; j < k; ++j) out[j] = cand[j].second;
    return out;
  }
};

// ---- IMF / BPR reference semantics (ref imf.hpp:57-119, bpr.hpp:56-106) ---
struct MFModel {
  size_t U, I, D;
  float lr, beta, lambda2;  // lambda2 = 2*lambda per touch
  int num_neg;
  std::vector<float> uv, iv, uv_ag, iv_ag, ub, ib, ub_ag, ib_ag;

  MFModel(size_t U_, size_t I_, size_t D_, float lr_, float beta_,
          float lambda_, int num_neg_)
      : U(U_), I(I_), D(D_), lr(lr_), beta(beta_), lambda2(2.f * lambda_),
        num_neg(num_neg_), uv(U * D), iv(I * D), uv_ag(U * D, 1e-4f),
        iv_ag(I * D, 1e-4f), ub(U, 0.f), ib(I, 0.f), ub_ag(U, 1e-4f),
        ib_ag(I, 1e-4f) {
    std::uniform_real_distribution<float> init(-0.01f, 0.01f);
    for (auto& w : uv) w = init(g_rng);
    for (auto& w : iv) w = init(g_rng);
  }

  float predict(size_t u, size_t i) const {
    float s = ub[u] + ib[i];
    for (size_t k = 0; k < D; ++k) s += uv[u * D + k] * iv[i * D + k];
    return s;
  }

  // pointwise square-loss step (ref imf.hpp:86-115)
  void imf_step(size_t u, size_t i, float truth) {
    float g = -2.f * (truth - predict(u, i));
    float gu = g + lambda2 * ub[u], gi = g + lambda2 * ib[i];
    ub_ag[u] += gu * gu;
    ib_ag[i] += gi * gi;
    ub[u] -= lr * gu / (beta + std::sqrt(ub_ag[u]));
    ib[i] -= lr * gi / (beta + std::sqrt(ib_ag[i]));
    for (size_t k = 0; k < D; ++k) {
      float gv = g * iv[i * D + k] + lambda2 * uv[u * D + k];
      float gw = g * uv[u * D + k] + lambda2 * iv[i * D + k];
      uv_ag[u * D + k] += gv * gv;
      iv_ag[i * D + k] += gw * gw;
      uv[u * D + k] -= lr * gv / (beta + std::sqrt(uv_ag[u * D + k]));
      iv[i * D + k] -= lr * gw / (beta + std::sqrt(iv_ag[i * D + k]));
    }
  }

  // pairwise LOG-loss step (ref bpr.hpp:72-106)
  void bpr_step(size_t u, size_t i, size_t j) {
    float z = predict(u, i) - predict(u, j);
    // LOG loss grad at truth 1: -1/(1+exp(z)) with ±18 clamps
    float g;
    if (z > 18.f) g = -std::exp(-z);
    else if (z < -18.f) g = -1.f;
    else g = -1.f / (1.f + std::exp(z));
    float gi = g + lambda2 * ib[i], gj = -g + lambda2 * ib[j];
    ib_ag[i] += gi * gi;
    ib_ag[j] += gj * gj;
    ib[i] -= lr * gi / (beta + std::sqrt(ib_ag[i]));
    ib[j] -= lr * gj / (beta + std::sqrt(ib_ag[j]));
    for (size_t k = 0; k < D; ++k) {
      float gv = g * (iv[i * D + k] - iv[j * D + k]) + lambda2 * uv[u * D + k];
      float gwi = g * uv[u * D + k] + lambda2 * iv[i * D + k];
      float gwj = -g * uv[u * D + k] + lambda2 * iv[j * D + k];
      uv_ag[u * D + k] += gv * gv;
      iv_ag[i * D + k] += gwi * gwi;
      iv_ag[j * D + k] += gwj * gwj;
      uv[u * D + k] -= lr * gv / (beta + std::sqrt(uv_ag[u * D + k]));
      iv[i * D + k] -= lr * gwi / (beta + std::sqrt(iv_ag[i * D + k]));
      iv[j * D + k] -= lr * gwj / (beta + std::sqrt(iv_ag[j * D + k]));
    }
  }

  // WARP pair step (ref warp.hpp:90-117): rank-weighted HINGE pair update,
  // NO bias updates (commented out in the reference), AdaGrad quotient is
  // sqrt(ag) WITHOUT the beta offset (warp.hpp:107-109).
  void warp_step(size_t u, size_t i, size_t j, float yui, float yuj, float l) {
    float z = yui - yuj;
    // HINGE loss grad at truth 1 (ref loss.hpp:290-296): -1 if 1-z>0 else 0
    float g = (1.f - z > 0.f) ? -1.f : 0.f;
    g *= l;
    for (size_t k = 0; k < D; ++k) {
      float gv = g * (iv[i * D + k] - iv[j * D + k]) + lambda2 * uv[u * D + k];
      float gwi = g * uv[u * D + k] + lambda2 * iv[i * D + k];
      float gwj = -g * uv[u * D + k] + lambda2 * iv[j * D + k];
      uv_ag[u * D + k] += gv * gv;
      iv_ag[i * D + k] += gwi * gwi;
      iv_ag[j * D + k] += gwj * gwj;
      uv[u * D + k] -= lr * gv / std::sqrt(uv_ag[u * D + k]);
      iv[i * D + k] -= lr * gwi / std::sqrt(iv_ag[i * D + k]);
      iv[j * D + k] -= lr * gwj / std::sqrt(iv_ag[j * D + k]);
    }
  }

  std::vector<int> recommend(size_t u, const std::vector<int>& rated,
                             size_t topk) const {
    std::unordered_set<int> rated_set(rated.begin(), rated.end());
    std::vector<std::pair<float, int>> cand;
    cand.reserve(I);
    for (size_t i = 0; i < I; ++i)
      if (!rated_set.count((int)i)) cand.push_back({predict(u, i), (int)i});
    size_t k = std::min(topk, cand.size());
    std::partial_sort(cand.begin(), cand.begin() + (long)k, cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    std::vector<int> out(k);
    for (size_t j = 0; j < k; ++j) out[j] = cand[j].second;
    return out;
  }
};

// ---- FISM reference semantics (ref fism.hpp:55-166) ----------------------
// Params p,q (I,D), x cache (U,D), biases bu/bi; AdaGrad quotient is plain
// sqrt(acc) with NO beta (fism.hpp:119-120,145,161); the x cache integrates
// the POST-normalization p-row deltas (fism.hpp:148,165).
struct FISMModel {
  size_t U, I, D;
  float lr, lambda;
  int num_neg, alpha;
  std::vector<float> p, p_ag, q, q_ag, x, bu, bi, bu_ag, bi_ag;

  FISMModel(size_t U_, size_t I_, size_t D_, float lr_, float lambda_,
            int num_neg_, int alpha_ = 1)
      : U(U_), I(I_), D(D_), lr(lr_), lambda(lambda_), num_neg(num_neg_),
        alpha(alpha_), p(I * D), p_ag(I * D, 1e-4f), q(I * D),
        q_ag(I * D, 1e-4f), x(U * D, 0.f), bu(U, 0.f), bi(I, 0.f),
        bu_ag(U, 1e-4f), bi_ag(I, 1e-4f) {
    std::uniform_real_distribution<float> init(-0.001f, 0.001f);
    for (auto& w : p) w = init(g_rng);
    for (auto& w : q) w = init(g_rng);
  }

  void build_x(const std::vector<std::vector<int>>& rated) {
    // x_u = sum_{j in rated(u)} p_j (ref fism.hpp:70-78)
    for (size_t u = 0; u < U; ++u) {
      float* xu = &x[u * D];
      for (size_t k = 0; k < D; ++k) xu[k] = 0.f;
      for (int j : rated[u])
        for (size_t k = 0; k < D; ++k) xu[k] += p[(size_t)j * D + k];
    }
  }

  inline float pow_scale(float n) const {
    float s = 1.f;
    for (int a = 0; a < alpha; ++a) s *= n;
    return 1.f / s;
  }

  // one SGD touch (ref fism.hpp:106-166); rated = iid in the user's set
  void update_one(size_t u, size_t iid, float truth, bool rated,
                  const std::vector<int>& items) {
    float n = (float)items.size();
    float scale = rated ? pow_scale(std::max(n - 1.f, 1.f)) : pow_scale(n);
    const float* xu = &x[u * D];
    const float* qi = &q[iid * D];
    const float* pi = &p[iid * D];
    float pred = bu[u] + bi[iid];
    if (rated) {
      for (size_t k = 0; k < D; ++k) pred += (xu[k] - pi[k]) * qi[k] * scale;
    } else {
      for (size_t k = 0; k < D; ++k) pred += xu[k] * qi[k] * scale;
    }
    float g = -2.f * (truth - pred);  // SQUARE loss (FISMConfig lt=SQUARE)
    float gbu = g + lambda * bu[u], gbi = g + lambda * bi[iid];
    bu_ag[u] += gbu * gbu;
    bi_ag[iid] += gbi * gbi;
    bu[u] -= lr * gbu / std::sqrt(bu_ag[u]);
    bi[iid] -= lr * gbi / std::sqrt(bi_ag[iid]);
    std::vector<float> x_grad(D, 0.f);
    for (int j : items) {
      if ((size_t)j == iid) continue;
      float* pj = &p[(size_t)j * D];
      float* pag = &p_ag[(size_t)j * D];
      for (size_t k = 0; k < D; ++k) {
        float gp = g * qi[k] * scale + lambda * pj[k];
        pag[k] += gp * gp;
        gp /= std::sqrt(pag[k]);
        pj[k] -= lr * gp;
        x_grad[k] += gp;
      }
    }
    float* qrow = &q[iid * D];
    float* qag = &q_ag[iid * D];
    for (size_t k = 0; k < D; ++k) {
      float gq = rated ? g * (xu[k] - pi[k]) * scale + lambda * qrow[k]
                       : g * xu[k] * scale + lambda * qrow[k];
      qag[k] += gq * gq;
      qrow[k] -= lr * gq / std::sqrt(qag[k]);
    }
    float* xum = &x[u * D];
    for (size_t k = 0; k < D; ++k) xum[k] -= lr * x_grad[k];
  }

  // ref fism.hpp:170-198: pred = bu + bi + scale·x·q
  std::vector<int> recommend(size_t u, const std::vector<int>& rated,
                             size_t topk) const {
    std::unordered_set<int> rated_set(rated.begin(), rated.end());
    float scale = pow_scale(std::max((float)rated.size(), 1.f));
    const float* xu = &x[u * D];
    std::vector<std::pair<float, int>> cand;
    cand.reserve(I);
    for (size_t i = 0; i < I; ++i) {
      if (rated_set.count((int)i)) continue;
      const float* qi = &q[i * D];
      float pred = bu[u] + bi[i];
      for (size_t k = 0; k < D; ++k) pred += scale * xu[k] * qi[k];
      cand.push_back({pred, (int)i});
    }
    size_t k = std::min(topk, cand.size());
    std::partial_sort(cand.begin(), cand.begin() + (long)k, cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    std::vector<int> out(k);
    for (size_t j = 0; j < k; ++j) out[j] = cand[j].second;
    return out;
  }
};

// ---- NegMF reference semantics (ref neg_mf.hpp + factor_model-inl.hpp) ---
// FactorModel over the global feature space [user ids | U+item ids]:
// pred = w_u + w_{U+i} + v_u·v_i; LOG loss labels +1/-1; AdaGrad quotient
// plain sqrt with accumulators initialized to ZERO (factor_model-inl.hpp:
// 12,19 — accumulate-before-quotient makes the first touch well defined).
struct NegMFModel {
  size_t U, I, D;
  float lr, lambda;
  int num_neg;
  std::vector<float> w, w_ag, v, v_ag;

  NegMFModel(size_t U_, size_t I_, size_t D_, float lr_, float lambda_,
             int num_neg_)
      : U(U_), I(I_), D(D_), lr(lr_), lambda(lambda_), num_neg(num_neg_),
        w((U_ + I_), 0.f), w_ag((U_ + I_), 0.f), v((U_ + I_) * D_),
        v_ag((U_ + I_) * D_, 0.f) {
    std::uniform_real_distribution<float> init(-0.01f, 0.01f);
    for (auto& e : w) e = init(g_rng);
    for (auto& e : v) e = init(g_rng);
  }

  inline float log_grad(float pred, float truth) const {
    float z = pred * truth;  // ref loss.hpp:189-198
    if (z > 18.f) return -truth * std::exp(-z);
    if (z < -18.f) return -truth;
    return -truth / (1.f + std::exp(z));
  }

  float predict(size_t u, size_t i) const {
    const float* vu = &v[u * D];
    const float* vi = &v[(U + i) * D];
    float s = w[u] + w[U + i];
    for (size_t k = 0; k < D; ++k) s += vu[k] * vi[k];
    return s;
  }

  // FactorModel::update_one_instance (factor_model-inl.hpp:65-128)
  void update_one(size_t u, size_t i, float truth) {
    float g = log_grad(predict(u, i), truth);
    size_t fu = u, fi = U + i;
    // factor grads use PRE-update rows of the opposite group
    std::vector<float> gu(D), gi(D);
    for (size_t k = 0; k < D; ++k) {
      gu[k] = lambda * v[fu * D + k] + g * v[fi * D + k];
      gi[k] = lambda * v[fi * D + k] + g * v[fu * D + k];
    }
    for (size_t f : {fu, fi}) {
      float gw = lambda * w[f] + g;
      w_ag[f] += gw * gw;
      w[f] -= lr * gw / std::sqrt(w_ag[f]);
    }
    for (size_t k = 0; k < D; ++k) {
      v_ag[fu * D + k] += gu[k] * gu[k];
      v[fu * D + k] -= lr * gu[k] / std::sqrt(v_ag[fu * D + k]);
      v_ag[fi * D + k] += gi[k] * gi[k];
      v[fi * D + k] -= lr * gi[k] / std::sqrt(v_ag[fi * D + k]);
    }
  }

  std::vector<int> recommend(size_t u, const std::vector<int>& rated,
                             size_t topk) const {
    std::unordered_set<int> rated_set(rated.begin(), rated.end());
    std::vector<std::pair<float, int>> cand;
    cand.reserve(I);
    for (size_t i = 0; i < I; ++i)
      if (!rated_set.count((int)i)) cand.push_back({predict(u, i), (int)i});
    size_t k = std::min(topk, cand.size());
    std::partial_sort(cand.begin(), cand.begin() + (long)k, cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
    std::vector<int> out(k);
    for (size_t j = 0; j < k; ++j) out[j] = cand[j].second;
    return out;
  }
};

// One reference-semantics epoch over all users for the MF family
// (ref imf.hpp:71-85, bpr.hpp:57-70, warp.hpp:63-88).
void mf_epoch(MFModel& m, const std::string& method,
              const std::vector<std::vector<int>>& train,
              const std::vector<double>* l_tab) {
  std::uniform_int_distribution<size_t> item_dist(0, m.I - 1);
  size_t U = train.size();
  for (size_t u = 0; u < U; ++u) {
    if (train[u].empty()) continue;
    std::unordered_set<int> item_set(train[u].begin(), train[u].end());
    size_t items_left = m.I - item_set.size();
    for (int i : train[u]) {
      if (method == "BPR") {
        for (int s = 0; s < m.num_neg; ++s) {
          int j;
          do { j = (int)item_dist(g_rng); } while (item_set.count(j));
          m.bpr_step(u, (size_t)i, (size_t)j);
        }
      } else if (method == "WARP") {
        // rejection loop to the FIRST violator, <=500 tries
        // (ref warp.hpp:71-84)
        float yui = m.predict(u, (size_t)i);
        for (int s = 0; s < m.num_neg; ++s) {
          size_t cnt = 0;
          int j = -1;
          float yuj = 0.f;
          while (true) {
            do { j = (int)item_dist(g_rng); } while (item_set.count(j));
            yuj = m.predict(u, (size_t)j);
            ++cnt;
            if (yuj > yui - 1.f || cnt >= 500) break;
          }
          if (cnt >= 500) continue;
          m.warp_step(u, (size_t)i, (size_t)j, yui, yuj,
                      (float)(*l_tab)[items_left / cnt]);
        }
      } else {  // MF (= IMF, SQUARE loss labels 1/0, ref imf.hpp:71-85)
        m.imf_step(u, (size_t)i, 1.f);
        for (int s = 0; s < m.num_neg; ++s) {
          int j;
          do { j = (int)item_dist(g_rng); } while (item_set.count(j));
          m.imf_step(u, (size_t)j, 0.f);
        }
      }
    }
  }
}

// SGD<FISM>/SGD<NegMF> instance-stream epoch: file order (grouped by user),
// each positive followed by num_neg rejection-sampled negatives
// (ref fism.hpp:91-104, neg_mf.hpp:74-89, sgd-inl.hpp:65-75).
template <typename ModelT>
void sgd_epoch(ModelT& m, const std::vector<std::vector<int>>& train,
               bool fism) {
  std::uniform_int_distribution<size_t> item_dist(0, m.I - 1);
  for (size_t u = 0; u < train.size(); ++u) {
    if (train[u].empty()) continue;
    std::unordered_set<int> item_set(train[u].begin(), train[u].end());
    for (int i : train[u]) {
      if constexpr (std::is_same_v<ModelT, FISMModel>) {
        m.update_one(u, (size_t)i, 1.f, true, train[u]);
      } else {
        m.update_one(u, (size_t)i, 1.f);
      }
      for (int s = 0; s < m.num_neg; ++s) {
        int j;
        do { j = (int)item_dist(g_rng); } while (item_set.count(j));
        if constexpr (std::is_same_v<ModelT, FISMModel>) {
          m.update_one(u, (size_t)j, 0.f, false, train[u]);
        } else {
          m.update_one(u, (size_t)j, -1.f);  // LOG negative label
        }
      }
    }
  }
  (void)fism;
}

std::vector<double> warp_l_table(size_t num_items) {
  // l_[idx] = l_[idx-1] + 1/(idx+1), l_[0] = 1 (ref warp.hpp:57-61)
  std::vector<double> l(num_items, 1.);
  for (size_t idx = 1; idx < num_items; ++idx)
    l[idx] = l[idx - 1] + 1. / (double)(idx + 1);
  return l;
}

// R@10 + MAP@10 over validation users (ref evaluation.hpp:183-218)
template <typename ModelT>
void print_topn_eval(const ModelT& m, const char* method,
                     const std::vector<std::vector<int>>& train,
                     const std::vector<std::vector<int>>& test,
                     size_t iters, size_t D) {
  double recall_sum = 0, map_sum = 0;
  size_t val_users = 0;
  for (size_t u = 0; u < train.size(); ++u) {
    if (u >= test.size() || test[u].empty()) continue;
    ++val_users;
    std::unordered_set<int> truth(test[u].begin(), test[u].end());
    auto rec = m.recommend(u, train[u], 10);
    double hits = 0, ap = 0;
    for (size_t r = 0; r < rec.size(); ++r) {
      if (truth.count(rec[r])) {
        hits += 1;
        ap += hits / (double)(r + 1);
      }
    }
    recall_sum += hits / (double)truth.size();
    map_sum += ap / std::min<double>(10.0, (double)truth.size());
  }
  std::printf(
      "{\"recall_at_10\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"method\": \"%s\", \"iters\": %zu, \"dim\": %zu}\n",
      recall_sum / (double)val_users, map_sum / (double)val_users, val_users,
      method, iters, D);
}

bool read_pairs(const char* path, std::vector<std::vector<int>>& rated,
                size_t& num_users, size_t& num_items) {
  std::ifstream f(path);
  if (!f) return false;
  size_t u, i;
  while (f >> u >> i) {
    if (u >= rated.size()) rated.resize(u + 1);
    rated[u].push_back((int)i);
    num_users = std::max(num_users, u + 1);
    num_items = std::max(num_items, i + 1);
  }
  return true;
}

int run_bench(int argc, char** argv) {
  size_t U = argc > 2 ? std::strtoul(argv[2], nullptr, 10) : 6040;
  size_t I = argc > 3 ? std::strtoul(argv[3], nullptr, 10) : 3706;
  size_t deg = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 160;
  size_t D = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 50;
  double budget_s = argc > 6 ? std::strtod(argv[6], nullptr) : 20.0;

  std::uniform_int_distribution<size_t> item_dist(0, I - 1);
  std::vector<std::vector<int>> rated(U);
  std::geometric_distribution<int> gdist(1.0 / (double)deg);
  for (size_t u = 0; u < U; ++u) {
    int n = std::min<int>(1 + gdist(g_rng), (int)I - 1);
    std::unordered_set<int> s;
    while ((int)s.size() < n) s.insert((int)item_dist(g_rng));
    rated[u].assign(s.begin(), s.end());
  }
  CDAEModel m(U, I, D, 0.1f, 0.01f, 0.f, 0.5f, 5, true);
  auto t0 = std::chrono::steady_clock::now();
  size_t users_done = 0, epochs = 0;
  double elapsed = 0;
  while (elapsed < budget_s) {
    for (size_t u = 0; u < U; ++u) {
      m.train_one_user(u, rated[u]);
      ++users_done;
    }
    ++epochs;
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0).count();
  }
  std::printf(
      "{\"users_per_sec\": %.2f, \"users\": %zu, \"epochs\": %zu, "
      "\"elapsed_s\": %.2f, \"U\": %zu, \"I\": %zu, \"dim\": %zu}\n",
      users_done / elapsed, users_done, epochs, elapsed, U, I, D);
  return 0;
}

// bench_mf <MF|BPR|WARP> [U I avg_degree dim seconds] — measures the
// reference-semantics sequential CPU hot loop in users/sec (the pairwise
// baseline the accelerator build must beat; VERDICT round-1 item 1).
int run_bench_mf(int argc, char** argv) {
  std::string method = argc > 2 ? argv[2] : "BPR";
  size_t U = argc > 3 ? std::strtoul(argv[3], nullptr, 10) : 6040;
  size_t I = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 3706;
  size_t deg = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 160;
  size_t D = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 10;
  double budget_s = argc > 7 ? std::strtod(argv[7], nullptr) : 20.0;

  std::uniform_int_distribution<size_t> item_dist(0, I - 1);
  std::vector<std::vector<int>> rated(U);
  std::geometric_distribution<int> gdist(1.0 / (double)deg);
  for (size_t u = 0; u < U; ++u) {
    int n = std::min<int>(1 + gdist(g_rng), (int)I - 1);
    std::unordered_set<int> s;
    while ((int)s.size() < n) s.insert((int)item_dist(g_rng));
    rated[u].assign(s.begin(), s.end());
  }
  float lambda = method == "WARP" ? 0.1f : 0.01f;  // ref warp.hpp:16
  float beta = method == "WARP" ? 0.f : 1.f;
  MFModel m(U, I, D, 0.1f, beta, lambda, 5);
  FISMModel fm(U, I, D, 0.1f, 0.01f, 5);
  NegMFModel nm(U, I, D, 0.1f, 0.01f, 5);
  if (method == "FISM") fm.build_x(rated);
  auto l_tab = warp_l_table(I);
  auto t0 = std::chrono::steady_clock::now();
  size_t epochs = 0;
  double elapsed = 0;
  while (elapsed < budget_s) {
    if (method == "FISM") sgd_epoch(fm, rated, true);
    else if (method == "NegMF") sgd_epoch(nm, rated, false);
    else mf_epoch(m, method, rated, &l_tab);
    ++epochs;
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0).count();
  }
  std::printf(
      "{\"method\": \"%s\", \"users_per_sec\": %.2f, \"epochs\": %zu, "
      "\"elapsed_s\": %.2f, \"U\": %zu, \"I\": %zu, \"dim\": %zu}\n",
      method.c_str(), (double)(U * epochs) / elapsed, epochs, elapsed, U, I,
      D);
  return 0;
}

int run_parity(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity train.txt test.txt "
                 "[iters dim cratio num_neg lr] [loss=CE] [asym] [tanh] "
                 "[linear] [lf] [no_uf]\n");
    return 2;
  }
  size_t iters = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 50;
  size_t D = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 50;
  float cratio = argc > 6 ? std::strtof(argv[6], nullptr) : 0.5f;
  int num_neg = argc > 7 ? (int)std::strtol(argv[7], nullptr, 10) : 5;
  float lr = argc > 8 ? std::strtof(argv[8], nullptr) : 0.1f;
  CDAEVariant var;
  std::string var_desc;
  for (int a = 9; a < argc; ++a) {
    std::string f = argv[a];
    if (f == "loss=CE") var.loss = 1;
    else if (f == "loss=SQUARE") var.loss = 0;
    else if (f == "asym") var.asymmetric = true;
    else if (f == "tanh") var.tanh = true;
    else if (f == "linear") var.linear = true;
    else if (f == "lf") var.linear_function = true;
    else if (f == "no_uf") var.user_factor = false;
    else {
      std::fprintf(stderr, "unknown variant flag: %s\n", f.c_str());
      return 2;
    }
    var_desc += (var_desc.empty() ? "" : ",") + f;
  }
  if (var_desc.empty()) var_desc = "base";

  std::vector<std::vector<int>> train, test;
  size_t U = 0, I = 0;
  if (!read_pairs(argv[2], train, U, I)) return 3;
  if (!read_pairs(argv[3], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);

  CDAEModel m(U, I, D, lr, 0.01f, 0.f, cratio, num_neg, true, var);
  for (size_t it = 0; it < iters; ++it)
    for (size_t u = 0; u < U; ++u)
      if (!train[u].empty()) m.train_one_user(u, train[u]);

  // TOPN evaluation: R@10 + MAP@10 over validation users
  // (ref evaluation.hpp:183-218)
  double recall_sum = 0, map_sum = 0;
  size_t val_users = 0;
  for (size_t u = 0; u < U; ++u) {
    if (test[u].empty()) continue;
    ++val_users;
    std::unordered_set<int> truth(test[u].begin(), test[u].end());
    auto rec = m.recommend(u, train[u], 10);
    double hits = 0, ap = 0;
    for (size_t r = 0; r < rec.size(); ++r) {
      if (truth.count(rec[r])) {
        hits += 1;
        ap += hits / (double)(r + 1);
      }
    }
    recall_sum += hits / (double)truth.size();
    map_sum += ap / std::min<double>(10.0, (double)truth.size());
  }
  std::printf(
      "{\"recall_at_10\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"U\": %zu, \"I\": %zu, \"iters\": %zu, \"dim\": %zu, "
      "\"variant\": \"%s\"}\n",
      recall_sum / (double)val_users, map_sum / (double)val_users, val_users,
      U, I, iters, D, var_desc.c_str());
  return 0;
}

// parity_mf <MF|BPR|WARP> train.txt test.txt [iters dim num_neg lr]
int run_parity_mf(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_mf <MF|BPR|WARP> train.txt "
                 "test.txt [iters dim num_neg lr]\n");
    return 2;
  }
  std::string method = argv[2];
  size_t iters = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 30;
  size_t D = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 10;
  int num_neg = argc > 7 ? (int)std::strtol(argv[7], nullptr, 10) : 5;
  float lr = argc > 8 ? std::strtof(argv[8], nullptr) : 0.1f;

  std::vector<std::vector<int>> train, test;
  size_t U = 0, I = 0;
  if (!read_pairs(argv[3], train, U, I)) return 3;
  if (!read_pairs(argv[4], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);

  if (method == "FISM") {
    FISMModel m(U, I, D, lr, 0.01f, num_neg);
    m.build_x(train);
    for (size_t it = 0; it < iters; ++it) sgd_epoch(m, train, true);
    print_topn_eval(m, "FISM", train, test, iters, D);
    return 0;
  }
  if (method == "NegMF") {
    NegMFModel m(U, I, D, lr, 0.01f, num_neg);
    for (size_t it = 0; it < iters; ++it) sgd_epoch(m, train, false);
    print_topn_eval(m, "NegMF", train, test, iters, D);
    return 0;
  }
  float lambda = method == "WARP" ? 0.1f : 0.01f;  // ref warp.hpp:16
  float beta = method == "WARP" ? 0.f : 1.f;
  MFModel m(U, I, D, lr, beta, lambda, num_neg);
  auto l_tab = warp_l_table(I);
  for (size_t it = 0; it < iters; ++it) mf_epoch(m, method, train, &l_tab);

  double recall_sum = 0, map_sum = 0;
  size_t val_users = 0;
  for (size_t u = 0; u < U; ++u) {
    if (test[u].empty()) continue;
    ++val_users;
    std::unordered_set<int> truth(test[u].begin(), test[u].end());
    auto rec = m.recommend(u, train[u], 10);
    double hits = 0, ap = 0;
    for (size_t r = 0; r < rec.size(); ++r) {
      if (truth.count(rec[r])) {
        hits += 1;
        ap += hits / (double)(r + 1);
      }
    }
    recall_sum += hits / (double)truth.size();
    map_sum += ap / std::min<double>(10.0, (double)truth.size());
  }
  std::printf(
      "{\"recall_at_10\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"method\": \"%s\", \"iters\": %zu, \"dim\": %zu}\n",
      recall_sum / (double)val_users, map_sum / (double)val_users, val_users,
      method.c_str(), iters, D);
  return 0;
}

bool read_triples(const char* path,
                  std::vector<std::vector<std::pair<int, float>>>& rated,
                  size_t& num_users, size_t& num_items);

bool read_triples(const char* path,
                  std::vector<std::vector<std::pair<int, float>>>& rated,
                  size_t& num_users, size_t& num_items);

// parity_fm <LINEAR|FM> train.txt test.txt [iters dim lr lambda]
// Reference LinearModel / FactorModel over rated (u, i, r) instances
// (linear_model-inl.hpp:46-68, factor_model-inl.hpp:65-128): SQUARE loss,
// global-mean offset, per-feature AdaGrad with ZERO-initialized
// accumulators (accumulate-then-quotient), factor term cross-group only.
// Judged on test RMSE — the classic bias / order-2 FM baselines.
int run_parity_fm(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_fm <LINEAR|FM> train.txt "
                 "test.txt [iters dim lr lambda]\n");
    return 2;
  }
  bool factors = std::strcmp(argv[2], "FM") == 0;
  size_t iters = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 20;
  size_t D = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 5;
  float lr = argc > 7 ? std::strtof(argv[7], nullptr) : 0.1f;
  float lambda = argc > 8 ? std::strtof(argv[8], nullptr) : 0.01f;

  std::vector<std::vector<std::pair<int, float>>> train, test;
  size_t U = 0, I = 0;
  if (!read_triples(argv[3], train, U, I)) return 3;
  if (!read_triples(argv[4], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);

  double mean = 0;
  size_t ntr = 0;
  for (auto& row : train)
    for (auto& pr : row) {
      mean += pr.second;
      ++ntr;
    }
  mean /= std::max<size_t>(ntr, 1);

  size_t F = U + I;
  std::vector<float> w(F), w_ag(F, 0.f), v, v_ag;
  std::uniform_real_distribution<float> init(-0.01f, 0.01f);
  for (auto& e : w) e = init(g_rng);
  if (factors) {
    v.resize(F * D);
    v_ag.assign(F * D, 0.f);
    for (auto& e : v) e = init(g_rng);
  }

  auto predict = [&](size_t u, size_t i) {
    double s = mean + w[u] + w[U + i];
    if (factors)
      for (size_t k = 0; k < D; ++k) s += v[u * D + k] * v[(U + i) * D + k];
    return s;
  };

  for (size_t it = 0; it < iters; ++it) {
    for (size_t u = 0; u < U; ++u)
      for (auto& pr : train[u]) {
        size_t fu = u, fi = U + (size_t)pr.first;
        float g = (float)(2.0 * (predict(u, (size_t)pr.first) -
                                 (double)pr.second));
        std::vector<float> gu(D), gi(D);
        if (factors)
          for (size_t k = 0; k < D; ++k) {
            gu[k] = lambda * v[fu * D + k] + g * v[fi * D + k];
            gi[k] = lambda * v[fi * D + k] + g * v[fu * D + k];
          }
        for (size_t f : {fu, fi}) {
          float gw = lambda * w[f] + g;
          w_ag[f] += gw * gw;
          w[f] -= lr * gw / std::sqrt(w_ag[f]);
        }
        if (factors)
          for (size_t k = 0; k < D; ++k) {
            v_ag[fu * D + k] += gu[k] * gu[k];
            v[fu * D + k] -= lr * gu[k] / std::sqrt(v_ag[fu * D + k]);
            v_ag[fi * D + k] += gi[k] * gi[k];
            v[fi * D + k] -= lr * gi[k] / std::sqrt(v_ag[fi * D + k]);
          }
      }
  }

  double se = 0;
  size_t n = 0;
  for (size_t u = 0; u < U; ++u)
    for (auto& pr : test[u]) {
      double d = predict(u, (size_t)pr.first) - (double)pr.second;
      se += d * d;
      ++n;
    }
  std::printf(
      "{\"rmse\": %.5f, \"n_test\": %zu, \"method\": \"%s\", "
      "\"iters\": %zu, \"dim\": %zu}\n",
      std::sqrt(se / (double)n), n, factors ? "FM" : "LINEAR", iters, D);
  return 0;
}

// parity_sim <ITEMCF|USERCF|POP> train.txt test.txt [sim_topk]
// Reference deterministic recommenders: Jaccard top-k co-occurrence
// neighbors (similarity_base.hpp:42-97) scored per itemcf.hpp:22-50 /
// usercf.hpp:21-55, and the sorted-popularity walk (popularity.hpp:23-41).
int run_parity_sim(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_sim <ITEMCF|USERCF|POP> "
                 "train.txt test.txt [sim_topk]\n");
    return 2;
  }
  std::string method = argv[2];
  size_t sim_topk = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 50;

  std::vector<std::vector<int>> train, test;
  size_t U = 0, I = 0;
  if (!read_pairs(argv[3], train, U, I)) return 3;
  if (!read_pairs(argv[4], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);
  std::vector<std::vector<int>> by_item(I);
  for (size_t u = 0; u < U; ++u)
    for (int i : train[u]) by_item[(size_t)i].push_back((int)u);

  // top-k Jaccard neighbors over the index side (items for ITEMCF, users
  // for USERCF) — exactly similarity_base.hpp's hash-map accumulation
  auto build_neighbors = [&](const std::vector<std::vector<int>>& idx_data,
                             const std::vector<std::vector<int>>& data_idx) {
    size_t N = idx_data.size();
    std::vector<std::vector<std::pair<int, double>>> nb(N);
    for (size_t a = 0; a < N; ++a) {
      if (idx_data[a].empty()) continue;
      std::unordered_map<int, double> cand;
      for (int d : idx_data[a])
        for (int b : data_idx[(size_t)d])
          if ((size_t)b != a) cand[b] += 1.0;
      std::vector<std::pair<int, double>> cv(cand.begin(), cand.end());
      for (auto& p : cv)
        p.second /= ((double)idx_data[(size_t)p.first].size() +
                     (double)idx_data[a].size() - p.second);
      size_t k = std::min(sim_topk, cv.size());
      std::partial_sort(cv.begin(), cv.begin() + (long)k, cv.end(),
                        [](auto& x, auto& y) { return x.second > y.second; });
      nb[a].assign(cv.begin(), cv.begin() + (long)k);
    }
    return nb;
  };

  std::vector<std::pair<int, double>> pop;
  std::vector<std::vector<std::pair<int, double>>> nb;
  if (method == "POP") {
    pop.resize(I);
    for (size_t i = 0; i < I; ++i) pop[i] = {(int)i, 0.0};
    for (size_t i = 0; i < I; ++i)
      pop[i].second = (double)by_item[i].size();
    std::sort(pop.begin(), pop.end(),
              [](auto& a, auto& b) { return a.second > b.second; });
  } else if (method == "ITEMCF") {
    nb = build_neighbors(by_item, train);
  } else {
    nb = build_neighbors(train, by_item);
  }

  double recall_sum = 0, map_sum = 0;
  size_t val_users = 0;
  for (size_t u = 0; u < U; ++u) {
    if (test[u].empty()) continue;
    ++val_users;
    std::unordered_set<int> truth(test[u].begin(), test[u].end());
    std::unordered_set<int> rated(train[u].begin(), train[u].end());
    std::vector<int> rec;
    if (method == "POP") {
      for (auto& p : pop) {
        if (rec.size() == 10) break;
        if (!rated.count(p.first)) rec.push_back(p.first);
      }
    } else {
      std::unordered_map<int, double> scores;
      if (method == "ITEMCF") {  // itemcf.hpp:22-50
        for (int ri : train[u])
          for (auto& p : nb[(size_t)ri])
            if (!rated.count(p.first)) scores[p.first] += p.second;
      } else {  // usercf.hpp:21-55
        for (auto& up : nb[u])
          for (int item : train[(size_t)up.first])
            if (!rated.count(item)) scores[item] += up.second;
      }
      std::vector<std::pair<int, double>> rp(scores.begin(), scores.end());
      size_t k = std::min<size_t>(10, rp.size());
      std::partial_sort(rp.begin(), rp.begin() + (long)k, rp.end(),
                        [](auto& a, auto& b) { return a.second > b.second; });
      for (size_t r = 0; r < k; ++r) rec.push_back(rp[r].first);
    }
    double hits = 0, ap = 0;
    for (size_t r = 0; r < rec.size(); ++r)
      if (truth.count(rec[r])) {
        hits += 1;
        ap += hits / (double)(r + 1);
      }
    recall_sum += hits / (double)truth.size();
    map_sum += ap / std::min<double>(10.0, (double)truth.size());
  }
  std::printf(
      "{\"recall_at_10\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"method\": \"%s\", \"sim_topk\": %zu}\n",
      recall_sum / (double)val_users, map_sum / (double)val_users, val_users,
      method.c_str(), sim_topk);
  return 0;
}

// Gauss-Jordan inverse with partial pivoting for the small d×d normal
// matrices (the reference uses Eigen's .inverse(), als.hpp:86)
static bool invert_inplace(std::vector<double>& A, size_t D) {
  std::vector<double> M(D * 2 * D, 0.0);
  for (size_t r = 0; r < D; ++r) {
    for (size_t c = 0; c < D; ++c) M[r * 2 * D + c] = A[r * D + c];
    M[r * 2 * D + D + r] = 1.0;
  }
  for (size_t col = 0; col < D; ++col) {
    size_t piv = col;
    for (size_t r = col + 1; r < D; ++r)
      if (std::fabs(M[r * 2 * D + col]) > std::fabs(M[piv * 2 * D + col]))
        piv = r;
    if (std::fabs(M[piv * 2 * D + col]) < 1e-12) return false;
    if (piv != col)
      for (size_t c = 0; c < 2 * D; ++c)
        std::swap(M[piv * 2 * D + c], M[col * 2 * D + c]);
    double d = M[col * 2 * D + col];
    for (size_t c = 0; c < 2 * D; ++c) M[col * 2 * D + c] /= d;
    for (size_t r = 0; r < D; ++r) {
      if (r == col) continue;
      double f = M[r * 2 * D + col];
      if (f == 0.0) continue;
      for (size_t c = 0; c < 2 * D; ++c)
        M[r * 2 * D + c] -= f * M[col * 2 * D + c];
    }
  }
  for (size_t r = 0; r < D; ++r)
    for (size_t c = 0; c < D; ++c) A[r * D + c] = M[r * 2 * D + D + c];
  return true;
}

// parity_als <ALS|WRMF> train.txt test.txt [iters dim lambda scalar]
// Reference alternating sweeps (als.hpp:66-121 / wrmf.hpp:66-121):
//   A = lambda·I + Σ w·y yᵀ,  x = A⁻¹ Σ rhs·y   per observed row,
// ALS: w = 1, rhs = rating (binary data: 1); WRMF: w = rhs = scalar·rating.
// Factors init U(-0.001, 0.001) (DMatrix::Random()*0.001, als.hpp:47-48).
int run_parity_als(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_als <ALS|WRMF> train.txt "
                 "test.txt [iters dim lambda scalar]\n");
    return 2;
  }
  std::string method = argv[2];
  bool weighted = method == "WRMF";
  size_t iters = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 20;
  size_t D = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 10;
  double lambda = argc > 7 ? std::strtod(argv[7], nullptr) : 0.01;
  double scalar = argc > 8 ? std::strtod(argv[8], nullptr) : 40.0;

  std::vector<std::vector<int>> train, test;
  size_t U = 0, I = 0;
  if (!read_pairs(argv[3], train, U, I)) return 3;
  if (!read_pairs(argv[4], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);
  std::vector<std::vector<int>> by_item(I);
  for (size_t u = 0; u < U; ++u)
    for (int i : train[u]) by_item[(size_t)i].push_back((int)u);

  std::vector<double> p(U * D), q(I * D);
  std::uniform_real_distribution<double> init(-0.001, 0.001);
  for (auto& e : p) e = init(g_rng);
  for (auto& e : q) e = init(g_rng);

  auto sweep = [&](std::vector<double>& X,
                   const std::vector<double>& Y,
                   const std::vector<std::vector<int>>& rows) {
    std::vector<double> A(D * D), b(D);
    for (size_t r = 0; r < rows.size(); ++r) {
      if (rows[r].empty()) continue;  // ref skips unseen ids (als.hpp:110)
      std::fill(A.begin(), A.end(), 0.0);
      std::fill(b.begin(), b.end(), 0.0);
      for (size_t k = 0; k < D; ++k) A[k * D + k] = lambda;
      for (int o : rows[r]) {
        const double* y = &Y[(size_t)o * D];
        double w = weighted ? scalar : 1.0;    // rating = 1 (binary pairs)
        double rhs = weighted ? scalar : 1.0;
        for (size_t i2 = 0; i2 < D; ++i2) {
          for (size_t j2 = 0; j2 < D; ++j2)
            A[i2 * D + j2] += w * y[i2] * y[j2];
          b[i2] += rhs * y[i2];
        }
      }
      if (!invert_inplace(A, D)) continue;
      double* x = &X[r * D];
      for (size_t k = 0; k < D; ++k) {
        double s = 0.0;
        for (size_t j2 = 0; j2 < D; ++j2) s += A[k * D + j2] * b[j2];
        x[k] = s;
      }
    }
  };

  for (size_t it = 0; it < iters; ++it) {
    sweep(p, q, train);
    sweep(q, p, by_item);
  }

  double recall_sum = 0, map_sum = 0;
  size_t val_users = 0;
  std::vector<std::pair<double, int>> cand;
  for (size_t u = 0; u < U; ++u) {
    if (test[u].empty()) continue;
    ++val_users;
    std::unordered_set<int> truth(test[u].begin(), test[u].end());
    std::unordered_set<int> rated(train[u].begin(), train[u].end());
    cand.clear();
    for (size_t i = 0; i < I; ++i) {
      if (rated.count((int)i)) continue;
      double s = 0.0;
      for (size_t k = 0; k < D; ++k) s += p[u * D + k] * q[i * D + k];
      cand.push_back({s, (int)i});
    }
    size_t k = std::min<size_t>(10, cand.size());
    std::partial_sort(cand.begin(), cand.begin() + (long)k, cand.end(),
                      [](auto& a, auto& b2) { return a.first > b2.first; });
    double hits = 0, ap = 0;
    for (size_t r = 0; r < k; ++r)
      if (truth.count(cand[r].second)) {
        hits += 1;
        ap += hits / (double)(r + 1);
      }
    recall_sum += hits / (double)truth.size();
    map_sum += ap / std::min<double>(10.0, (double)truth.size());
  }
  std::printf(
      "{\"recall_at_10\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"method\": \"%s\", \"iters\": %zu, \"dim\": %zu}\n",
      recall_sum / (double)val_users, map_sum / (double)val_users, val_users,
      method.c_str(), iters, D);
  return 0;
}

// parity_pmf train.txt test.txt [iters dim lr]
// PMF reference semantics (ref pmf.hpp:71-115): rating MF over OBSERVED
// entries only — per-user sequential SQUARE-loss AdaGrad steps with the
// actual rating as the label, no negative sampling. Reports test RMSE
// (the reference's RMSE evaluator, evaluation.hpp:74-101).
int run_parity_pmf(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_pmf train.txt test.txt "
                 "[iters dim lr]\n");
    return 2;
  }
  size_t iters = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 30;
  size_t D = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 10;
  float lr = argc > 6 ? std::strtof(argv[6], nullptr) : 0.1f;

  std::vector<std::vector<std::pair<int, float>>> train, test;
  size_t U = 0, I = 0;
  if (!read_triples(argv[2], train, U, I)) return 3;
  if (!read_triples(argv[3], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);

  MFModel m(U, I, D, lr, 1.f, 0.01f, 0);  // beta=1, lambda=0.01 (pmf.hpp)
  for (size_t it = 0; it < iters; ++it)
    for (size_t u = 0; u < U; ++u)
      for (auto& pr : train[u])
        m.imf_step(u, (size_t)pr.first, pr.second);

  double se = 0;
  size_t n = 0;
  for (size_t u = 0; u < U; ++u)
    for (auto& pr : test[u]) {
      double d = (double)m.predict(u, (size_t)pr.first) - (double)pr.second;
      se += d * d;
      ++n;
    }
  std::printf(
      "{\"rmse\": %.5f, \"n_test\": %zu, \"method\": \"PMF\", "
      "\"iters\": %zu, \"dim\": %zu}\n",
      std::sqrt(se / (double)n), n, iters, D);
  return 0;
}

bool read_triples(const char* path,
                  std::vector<std::vector<std::pair<int, float>>>& rated,
                  size_t& num_users, size_t& num_items) {
  std::ifstream f(path);
  if (!f) return false;
  size_t u, i;
  float r;
  while (f >> u >> i >> r) {
    if (u >= rated.size()) rated.resize(u + 1);
    rated[u].push_back({(int)i, r});
    num_users = std::max(num_users, u + 1);
    num_items = std::max(num_items, i + 1);
  }
  return true;
}

// RANKING list scoring — the reference's exact math
// (ref evaluation.hpp:309-361): 2^rel-1 gains, NATURAL-log discount,
// IDCG from the sorted ground truth, rel >= 4 counts a Prec/Recall/MAP hit.
std::vector<double> ranking_rec_list(
    const std::vector<int>& list,
    const std::vector<std::pair<int, float>>& truth) {
  std::vector<double> rets(8, 0.);
  std::vector<std::pair<int, float>> gt(truth);
  std::sort(gt.begin(), gt.end(),
            [](auto& a, auto& b) { return a.second > b.second; });
  std::unordered_map<int, float> map;
  for (auto& p : truth) map[p.first] = p.second;

  double DCG5 = 0, DCG10 = 0, IDCG5 = 0, IDCG10 = 0;
  double hit5 = 0, hit10 = 0, map5 = 0, map10 = 0;
  for (size_t idx = 0; idx < 10; ++idx) {
    if (idx < gt.size()) {
      double ig = (std::pow(2., (double)gt[idx].second) - 1.) /
                  std::log(idx + 2.);
      if (idx < 5) IDCG5 += ig;
      IDCG10 += ig;
    }
    if (idx >= list.size()) continue;
    auto it = map.find(list[idx]);
    if (it != map.end()) {
      double g = (std::pow(2., (double)it->second) - 1.) / std::log(idx + 2.);
      if (idx < 5) DCG5 += g;
      DCG10 += g;
      if (it->second >= 4.f) {
        if (idx < 5) {
          hit5 += 1.;
          map5 += hit5 / (idx + 1.);
        }
        hit10 += 1.;
        map10 += hit10 / (idx + 1.);
      }
    }
  }
  rets[0] = IDCG5 > 0 ? DCG5 / IDCG5 : 0.;
  rets[1] = IDCG10 > 0 ? DCG10 / IDCG10 : 0.;
  rets[2] = hit5 / 5.;
  rets[3] = hit10 / 10.;
  int num_rels = (int)std::count_if(
      truth.begin(), truth.end(),
      [](const std::pair<int, float>& v) { return v.second >= 4.f; });
  if (num_rels > 0) {
    rets[4] = hit5 / num_rels;
    rets[5] = hit10 / num_rels;
    rets[6] = map5 / std::min(5., (double)truth.size());
    rets[7] = map10 / std::min(10., (double)truth.size());
  }
  return rets;
}

// parity_ranking train.txt test.txt [iters dim lr] — PMF (rating MF,
// ref pmf.hpp:80-109: per-instance AdaGrad SGD on observed ratings, SQUARE
// loss) trained sequentially, then the RANKING evaluator over val users
// (ref evaluation.hpp:223-361; rec list excludes train items).
int run_parity_ranking(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: baseline_cdae parity_ranking train.txt test.txt "
                 "[iters dim lr]\n");
    return 2;
  }
  size_t iters = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 30;
  size_t D = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 10;
  float lr = argc > 6 ? std::strtof(argv[6], nullptr) : 0.1f;

  std::vector<std::vector<std::pair<int, float>>> train, test;
  size_t U = 0, I = 0;
  if (!read_triples(argv[2], train, U, I)) return 3;
  if (!read_triples(argv[3], test, U, I)) return 3;
  train.resize(U);
  test.resize(U);

  MFModel m(U, I, D, lr, 1.f, 0.01f, 0);
  for (size_t it = 0; it < iters; ++it)
    for (size_t u = 0; u < U; ++u)
      for (auto& p : train[u]) m.imf_step(u, (size_t)p.first, p.second);

  std::vector<double> sums(8, 0.);
  size_t val_users = 0;
  for (size_t u = 0; u < U; ++u) {
    if (test[u].empty()) continue;
    ++val_users;
    std::vector<int> rated;
    rated.reserve(train[u].size());
    for (auto& p : train[u]) rated.push_back(p.first);
    auto rec = m.recommend(u, rated, 10);
    auto rets = ranking_rec_list(rec, test[u]);
    for (size_t k = 0; k < 8; ++k) sums[k] += rets[k];
  }
  std::printf(
      "{\"ndcg_at_5\": %.5f, \"ndcg_at_10\": %.5f, \"prec_at_5\": %.5f, "
      "\"prec_at_10\": %.5f, \"recall_at_5\": %.5f, \"recall_at_10\": %.5f, "
      "\"map_at_5\": %.5f, \"map_at_10\": %.5f, \"val_users\": %zu, "
      "\"iters\": %zu, \"dim\": %zu}\n",
      sums[0] / val_users, sums[1] / val_users, sums[2] / val_users,
      sums[3] / val_users, sums[4] / val_users, sums[5] / val_users,
      sums[6] / val_users, sums[7] / val_users, val_users, iters, D);
  return 0;
}

// bench_als <ALS|WRMF> [U I deg D lambda scalar seconds] — reference-
// semantics sequential ALS (per-row D x D normal equations + dense
// inverse, ref als.hpp:65-107 / wrmf.hpp:66-100) on synthetic data with
// the same generator as bench_mf; reports ms per full user+item sweep.
// The CPU baseline row for the accelerator ShardedALS/fused-iteration numbers
// (VERDICT r4 item 7).
int run_bench_als(int argc, char** argv) {
  std::string method = argc > 2 ? argv[2] : "ALS";
  bool weighted = method == "WRMF";
  size_t U = argc > 3 ? std::strtoul(argv[3], nullptr, 10) : 6040;
  size_t I = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 3706;
  size_t deg = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 160;
  size_t D = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 10;
  double lambda = argc > 7 ? std::strtod(argv[7], nullptr) : 0.01;
  double scalar = argc > 8 ? std::strtod(argv[8], nullptr) : 40.0;
  double budget_s = argc > 9 ? std::strtod(argv[9], nullptr) : 20.0;

  std::uniform_int_distribution<size_t> item_dist(0, I - 1);
  std::geometric_distribution<int> gdist(1.0 / (double)deg);
  std::vector<std::vector<int>> train(U), by_item(I);
  for (size_t u = 0; u < U; ++u) {
    int n = std::min<int>(1 + gdist(g_rng), (int)I - 1);
    std::unordered_set<int> s;
    while ((int)s.size() < n) s.insert((int)item_dist(g_rng));
    train[u].assign(s.begin(), s.end());
    for (int i : train[u]) by_item[(size_t)i].push_back((int)u);
  }
  std::vector<double> p(U * D), q(I * D);
  std::uniform_real_distribution<double> init(-0.001, 0.001);
  for (auto& e : p) e = init(g_rng);
  for (auto& e : q) e = init(g_rng);

  auto sweep = [&](std::vector<double>& X, const std::vector<double>& Y,
                   const std::vector<std::vector<int>>& rows) {
    std::vector<double> A(D * D), b(D);
    for (size_t r = 0; r < rows.size(); ++r) {
      if (rows[r].empty()) continue;  // ref skips unseen ids (als.hpp:110)
      std::fill(A.begin(), A.end(), 0.0);
      std::fill(b.begin(), b.end(), 0.0);
      for (size_t k = 0; k < D; ++k) A[k * D + k] = lambda;
      for (int o : rows[r]) {
        const double* y = &Y[(size_t)o * D];
        double w = weighted ? scalar : 1.0;
        double rhs = weighted ? scalar : 1.0;
        for (size_t i2 = 0; i2 < D; ++i2) {
          for (size_t j2 = 0; j2 < D; ++j2)
            A[i2 * D + j2] += w * y[i2] * y[j2];
          b[i2] += rhs * y[i2];
        }
      }
      if (!invert_inplace(A, D)) continue;
      double* x = &X[r * D];
      for (size_t k = 0; k < D; ++k) {
        double s = 0.0;
        for (size_t j2 = 0; j2 < D; ++j2) s += A[k * D + j2] * b[j2];
        x[k] = s;
      }
    }
  };

  auto t0 = std::chrono::steady_clock::now();
  size_t iters = 0;
  double elapsed = 0;
  while (elapsed < budget_s) {
    sweep(p, q, train);
    sweep(q, p, by_item);
    ++iters;
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0).count();
  }
  std::printf(
      "{\"method\": \"%s\", \"ms_per_iter\": %.2f, \"iters\": %zu, "
      "\"U\": %zu, \"I\": %zu, \"dim\": %zu}\n",
      method.c_str(), 1e3 * elapsed / (double)iters, iters, U, I, D);
  return 0;
}

// bench_sim <ITEMCF|USERCF> [U I deg topk reps] — reference-semantics
// co-occurrence neighbor build (hash-map candidate counting + Jaccard +
// per-index top-k, ref similarity_base.hpp:42-95) on synthetic data;
// reports seconds per full build. The CPU baseline row for the accelerator
// SimilarityBase sparse-matmul build (VERDICT r4 item 7).
int run_bench_sim(int argc, char** argv) {
  std::string method = argc > 2 ? argv[2] : "ITEMCF";
  size_t U = argc > 3 ? std::strtoul(argv[3], nullptr, 10) : 6040;
  size_t I = argc > 4 ? std::strtoul(argv[4], nullptr, 10) : 3706;
  size_t deg = argc > 5 ? std::strtoul(argv[5], nullptr, 10) : 160;
  size_t topk = argc > 6 ? std::strtoul(argv[6], nullptr, 10) : 50;
  size_t reps = argc > 7 ? std::strtoul(argv[7], nullptr, 10) : 3;

  std::uniform_int_distribution<size_t> item_dist(0, I - 1);
  std::geometric_distribution<int> gdist(1.0 / (double)deg);
  std::vector<std::vector<int>> train(U), by_item(I);
  for (size_t u = 0; u < U; ++u) {
    int n = std::min<int>(1 + gdist(g_rng), (int)I - 1);
    std::unordered_set<int> s;
    while ((int)s.size() < n) s.insert((int)item_dist(g_rng));
    train[u].assign(s.begin(), s.end());
    for (int i : train[u]) by_item[(size_t)i].push_back((int)u);
  }
  if (method == "POP") {
    // popularity recommend throughput: sorted count list, walk skipping
    // rated until 10 (ref popularity.hpp:23-41 + reset :43-61)
    std::vector<std::pair<double, int>> pop(I);
    for (size_t i = 0; i < I; ++i)
      pop[i] = {(double)by_item[i].size(), (int)i};
    std::sort(pop.begin(), pop.end(),
              [](auto& a, auto& b) { return a.first > b.first; });
    double best_dt = 1e30;
    size_t sink = 0;
    for (size_t rep = 0; rep < reps; ++rep) {
      auto t0 = std::chrono::steady_clock::now();
      for (size_t u = 0; u < U; ++u) {
        std::unordered_set<int> rated(train[u].begin(), train[u].end());
        size_t got = 0;
        for (auto& pr : pop) {
          if (got == 10) break;
          if (!rated.count(pr.second)) { sink += (size_t)pr.second; ++got; }
        }
      }
      double dt = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0).count();
      best_dt = std::min(best_dt, dt);
    }
    std::printf(
        "{\"method\": \"POP\", \"rec_users_per_sec\": %.1f, \"U\": %zu, "
        "\"I\": %zu, \"checksum\": %zu}\n",
        (double)U / best_dt, U, I, sink);
    return 0;
  }
  const auto& idx_data = method == "ITEMCF" ? by_item : train;
  const auto& data_idx = method == "ITEMCF" ? train : by_item;

  double best = 1e30;
  size_t checksum = 0;
  for (size_t rep = 0; rep < reps; ++rep) {
    auto t0 = std::chrono::steady_clock::now();
    size_t N = idx_data.size();
    std::vector<std::vector<std::pair<int, double>>> nb(N);
    for (size_t a = 0; a < N; ++a) {
      if (idx_data[a].empty()) continue;
      std::unordered_map<int, double> cand;
      for (int d : idx_data[a])
        for (int b : data_idx[(size_t)d])
          if ((size_t)b != a) cand[b] += 1.0;
      std::vector<std::pair<int, double>> cv(cand.begin(), cand.end());
      for (auto& pr : cv)
        pr.second /= ((double)idx_data[(size_t)pr.first].size() +
                      (double)idx_data[a].size() - pr.second);
      size_t k = std::min(topk, cv.size());
      std::partial_sort(cv.begin(), cv.begin() + (long)k, cv.end(),
                        [](auto& x, auto& y) { return x.second > y.second; });
      nb[a].assign(cv.begin(), cv.begin() + (long)k);
      checksum += nb[a].size();
    }
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    best = std::min(best, dt);
  }
  std::printf(
      "{\"method\": \"%s\", \"build_s\": %.3f, \"topk\": %zu, \"U\": %zu, "
      "\"I\": %zu, \"checksum\": %zu}\n",
      method.c_str(), best, topk, U, I, checksum);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "parity") == 0)
    return run_parity(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_ranking") == 0)
    return run_parity_ranking(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_mf") == 0)
    return run_parity_mf(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_pmf") == 0)
    return run_parity_pmf(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_als") == 0)
    return run_parity_als(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_sim") == 0)
    return run_parity_sim(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "parity_fm") == 0)
    return run_parity_fm(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "bench_mf") == 0)
    return run_bench_mf(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "bench_als") == 0)
    return run_bench_als(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "bench_sim") == 0)
    return run_bench_sim(argc, argv);
  if (argc > 1 && std::strcmp(argv[1], "bench") == 0)
    return run_bench(argc, argv);
  // legacy positional form: treat argv as bench args shifted by one
  std::vector<char*> shifted;
  shifted.push_back(argv[0]);
  shifted.push_back(const_cast<char*>("bench"));
  for (int i = 1; i < argc; ++i) shifted.push_back(argv[i]);
  return run_bench((int)shifted.size(), shifted.data());
}
