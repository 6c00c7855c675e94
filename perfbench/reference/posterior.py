"""The sBayes posterior of a batch of chain states, from its definition.

Given the raw data (``perfbench/datagen.py``'s arrays), the model section
of a configuration and the states a program ended in (clusters, mixture
weights, the source component of every observation), ``Reference``
recomputes what such a program carries with each state:

* the collapsed counts: per cluster and per confounder group, how many
  observations of each (feature, state) are assigned to that component;
  and per availability pattern of an object (which components it may
  come from) how many of its observations each component took;
* the collapsed Dirichlet-categorical log-likelihood of those counts;
* the log-prior and its four parts [cluster size, geo, weights, source];
* the skeleton of each cluster under the geo prior: [total cost, number
  of edges, longest edge] of its minimum spanning tree;
* the membership marginal: the log-odds of every object being in a
  cluster under given effects and weights (the function the program's
  marginal kernel computes).

Everything runs in ``dtype`` (float64, or a lower precision for the
control) on any torch device, a block of chains at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.geodesic import cost_matrix

TINY = 1e-35


class Reference:
    def __init__(self, arrays: dict, model_cfg: dict, device="cpu", dtype=torch.float64):
        values = np.asarray(arrays["values"])
        self.N, self.F, self.S = values.shape
        self.device, self.dtype = torch.device(device), dtype
        observed = values.any(-1)
        feat = np.where(observed, values.argmax(-1), self.S)
        self.feat = torch.as_tensor(feat, dtype=torch.long, device=self.device)     # (N, F)
        self.observed = torch.as_tensor(observed, device=self.device)
        self.applicable = torch.as_tensor(np.asarray(arrays["applicable"]), device=self.device)
        self.K = int(model_cfg["clusters"])
        prior = model_cfg["prior"]
        for name in ("cluster_effect", "weights"):
            if prior[name]["type"] != "uniform":
                raise ValueError(f"the reference knows only a uniform {name} prior")
        # One membership matrix per confounder: universal = one group of all.
        groups = []
        for name in model_cfg["confounders"]:
            for spec in prior["confounding_effects"][name].values():
                if spec["type"] != "uniform":
                    raise ValueError("the reference knows only uniform confounding effects")
            if name == "universal":
                groups.append(np.ones((1, self.N), bool))
            elif name == "family":
                groups.append(np.asarray(arrays["families"], bool))
            else:
                raise ValueError(f"unknown confounder {name}")
        self.n_groups = [g.shape[0] for g in groups]
        self.C = len(groups) + 1
        # (C-1, N): the group of each object per confounder, -1 for none
        gidx = np.stack([np.where(g.any(0), g.argmax(0), -1) for g in groups])
        self.group_of = torch.as_tensor(gidx, dtype=torch.long, device=self.device)
        in_conf = gidx.T >= 0                                              # (N, C-1)
        self.in_conf = torch.as_tensor(in_conf, device=self.device)
        rows, pattern = np.unique(in_conf, axis=0, return_inverse=True)
        self.n_static = rows.shape[0]
        self.static_pattern = torch.as_tensor(pattern.reshape(-1), device=self.device)
        size = prior["objects_per_cluster"]
        if size["type"] != "uniform_area":
            raise ValueError("the reference knows only the uniform_area size prior")
        self.min_size, self.max_size = int(size["min"]), int(min(size["max"], self.N))
        self.geo = prior["geo"]
        self.cost = None
        if self.geo["type"] == "cost_based":
            if self.geo.get("skeleton", "mst") != "mst" or self.geo.get(
                    "probability_function", "exponential") != "exponential":
                raise ValueError("the reference knows only the MST skeleton, exponential")
            self.cost = torch.as_tensor(cost_matrix(arrays["locations"], arrays["geodesic"]),
                                        dtype=dtype, device=self.device)
        elif self.geo["type"] != "uniform":
            raise ValueError(f"the reference knows no geo prior {self.geo['type']}")

    # ---------------- states ----------------

    def source_index(self, source) -> torch.Tensor:
        """(B, N, F) component of each observation, C at NA, from either
        form a program stores: an int8 index or a bool one-hot (B, N, F, C)."""
        src = torch.as_tensor(np.asarray(source), device=self.device)
        if src.dim() == 4:
            src = torch.where(src.any(-1), src.to(torch.uint8).argmax(-1),
                              torch.full((), self.C, dtype=torch.long, device=self.device))
        src = src.long()
        return torch.where(self.observed[None], src, torch.full_like(src, self.C))

    def counts(self, clusters, src):
        """Integer counts: (B, K, F, S) of the clusters, (B, C-1, G, F, S)
        of the confounder groups (G the most groups of a confounder), and
        (B, P, F, C) per availability pattern."""
        B = clusters.shape[0]
        K, N, F, S, C = self.K, self.N, self.F, self.S, self.C
        f_ar = torch.arange(F, device=self.device)[None, None]
        b_ar = torch.arange(B, device=self.device)[:, None, None]
        cell = self.feat[None].expand(B, N, F)
        obs = self.observed[None].expand(B, N, F)
        # clusters: the member's observations from component 0
        member_k = torch.where(clusters.any(1), clusters.long().argmax(1), -1)      # (B, N)
        take = obs & (src == 0) & (member_k[:, :, None] >= 0)
        idx = ((b_ar * K + member_k[:, :, None]) * F + f_ar) * S + cell
        cl = torch.bincount(idx[take], minlength=B * K * F * S).view(B, K, F, S)
        G = max(self.n_groups)
        conf = []
        for i in range(C - 1):
            g = self.group_of[i][None, :, None]
            take = obs & (src == 1 + i) & (g >= 0)
            idx = ((b_ar * G + g) * F + f_ar) * S + cell
            conf.append(torch.bincount(idx[take], minlength=B * G * F * S).view(B, G, F, S))
        conf = torch.stack(conf, 1)
        pattern = self.static_pattern[None] + clusters.any(1).long() * self.n_static  # (B, N)
        P = 2 * self.n_static
        take = obs & (src < C)
        idx = ((b_ar * P + pattern[:, :, None]) * F + f_ar) * C + src
        pat = torch.bincount(idx[take], minlength=B * P * F * C).view(B, P, F, C)
        return cl, conf, pat

    def log_likelihood(self, cl, conf) -> torch.Tensor:
        """(B,) collapsed Dirichlet-categorical log-likelihood of the counts,
        each cluster and each real confounder group under a uniform
        Dirichlet prior (concentration 1 on the applicable states)."""
        a = self.applicable.to(self.dtype)                                   # (F, S)
        rows = [cl.to(self.dtype)] + [conf[:, i, :n].to(self.dtype)
                                      for i, n in enumerate(self.n_groups)]
        counts = torch.cat(rows, 1)                                          # (B, R, F, S)
        sum_a = a.sum(-1)
        n = counts.sum(-1)
        series = torch.where(a > 0, torch.lgamma(counts + a) - torch.lgamma(a),
                             torch.zeros((), dtype=self.dtype, device=self.device)).sum(-1)
        return (torch.lgamma(sum_a) - torch.lgamma(n + sum_a) + series).sum((-1, -2))

    def skeletons(self, masks) -> torch.Tensor:
        """(M, 3) [total, n_edges, longest edge] of the minimum spanning
        tree of each member set in ``masks`` (M, N), by Prim's algorithm."""
        M, N = masks.shape
        ar = torch.arange(M, device=self.device)
        size = masks.sum(1)
        inf = torch.full((), float("inf"), dtype=self.dtype, device=self.device)
        in_tree = torch.zeros_like(masks)
        first = masks.long().argmax(1)
        in_tree[ar, first] = masks[ar, first]
        best = torch.where(masks & ~in_tree, self.cost[first], inf)
        total = torch.zeros(M, dtype=self.dtype, device=self.device)
        longest = torch.zeros_like(total)
        for it in range(max(int(size.max()) - 1, 0)):
            j = best.argmin(1)
            e = best[ar, j]
            grow = size - 1 > it
            total = torch.where(grow, total + e, total)
            longest = torch.where(grow, torch.maximum(longest, e), longest)
            in_tree[ar[grow], j[grow]] = True
            best = torch.where(masks & ~in_tree, torch.minimum(best, self.cost[j]), inf)
        return torch.stack([total, (size - 1).clamp(min=0).to(self.dtype), longest], -1)

    def geo_prior(self, clusters):
        """((B,) log geo prior, (B, K, 3) skeletons or None)."""
        B = clusters.shape[0]
        if self.cost is None:
            return torch.zeros(B, dtype=self.dtype, device=self.device), None
        sk = self.skeletons(clusters.reshape(B * self.K, self.N)).view(B, self.K, 3)
        agg = self.geo.get("aggregation", "mean")
        if agg == "mean":
            cost = sk[..., 0] / sk[..., 1].clamp(min=1)
        elif agg == "sum":
            cost = sk[..., 0]
        else:
            cost = sk[..., 2]
        return (-cost / float(self.geo["rate"])).sum(-1), sk

    def available(self, clusters) -> torch.Tensor:
        """(B, N, C) whether each component may explain each object."""
        return torch.cat([clusters.any(1)[..., None],
                          self.in_conf[None].expand(clusters.shape[0], -1, -1)], -1)

    def source_prior(self, clusters, weights, src) -> torch.Tensor:
        """(B,) log P(source | weights): each observation's component drawn
        from the weights renormalised over the components available to it."""
        w = torch.as_tensor(np.asarray(weights), device=self.device).to(self.dtype)  # (B, F, C)
        hc = self.available(clusters).to(self.dtype)                               # (B, N, C)
        wn = w[:, None] * hc[:, :, None]                                           # (B, N, F, C)
        wn = wn / wn.sum(-1, keepdim=True)
        picked = torch.gather(wn, 3, src.clamp(max=self.C - 1)[..., None])[..., 0]
        obs = src < self.C
        return torch.where(obs, torch.log(torch.where(obs, picked, torch.ones_like(picked))),
                           torch.zeros_like(picked)).sum((-1, -2))

    def block(self, cells: int = 100_000_000) -> int:
        """Chains a block: about ``cells`` (object, feature) cells at once."""
        return max(1, cells // (self.N * self.F))

    def evaluate(self, clusters, weights, source) -> dict:
        """Everything a state carries, for a batch of states given as numpy
        arrays, a ``block()`` of chains at a time. Returns numpy arrays
        (floats as float64)."""
        clusters = np.asarray(clusters, bool)
        out: dict = {}
        block = self.block()
        for lo in range(0, clusters.shape[0], block):
            sl = slice(lo, lo + block)
            cl_mask = torch.as_tensor(clusters[sl], device=self.device)
            src = self.source_index(np.asarray(source)[sl])
            cl, conf, pat = self.counts(cl_mask, src)
            sizes = cl_mask.sum(-1)
            geo, sk = self.geo_prior(cl_mask)
            zero = torch.zeros_like(geo)
            parts = torch.stack([zero, geo, zero,
                                 self.source_prior(cl_mask, np.asarray(weights)[sl], src)], -1)
            part = {"cl_counts": cl, "conf_counts": conf, "pat_counts": pat,
                    "log_lh": self.log_likelihood(cl, conf), "prior_parts": parts,
                    "log_prior": parts.sum(-1), "sizes": sizes,
                    "overlap": (cl_mask.sum(1) > 1).any(-1)}
            if sk is not None:
                part["geo_agg"] = sk
            for k, v in part.items():
                out.setdefault(k, []).append(v.double().cpu() if v.is_floating_point()
                                             else v.cpu())
        return {k: torch.cat(v).numpy() for k, v in out.items()}

    # ---------------- the membership marginal ----------------

    def marginal(self, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None) -> np.ndarray:
        """``marginal_block`` over blocks of chains; float64 numpy (B, N)."""
        block = max(1, self.block() // 8)
        B = np.asarray(incl).shape[0]
        parts = [self.marginal_block(*(np.asarray(x)[lo:lo + block] for x in (
            p_eff, conf_eff, wh, hc, hc_flip, incl)),
            None if inv_t is None else np.asarray(inv_t)[lo:lo + block])
            for lo in range(0, B, block)]
        return np.concatenate(parts)

    def marginal_block(self, p_eff, conf_eff, wh, hc, hc_flip, incl, inv_t=None):
        """(B, N) log-odds of membership (the ratio form): per object the
        sum over features of log (s_cur / s_flip * z_flip / z_cur), where
        s = sum_c wh[f, c] hc[n, c] lh_c[n, f] and z = sum_c wh[f, c] hc[n, c],
        lh_0 the cluster effect ``p_eff`` (B, F, S) (raised to ``inv_t``) and
        lh_c the effect of the object's group of confounder c; 1 at NA;
        the sign flipped for objects not in the cluster (``incl`` 0)."""
        t = {k: torch.as_tensor(np.asarray(v), device=self.device).to(self.dtype)
             for k, v in dict(p=p_eff, conf=conf_eff, wh=wh, hc=hc, hcf=hc_flip,
                              incl=incl).items()}
        if t["p"].dim() == 4:                                               # (B, 1, F, S)
            t["p"] = t["p"][:, 0]
        B = t["p"].shape[0]
        feat = self.feat.clamp(max=self.S - 1)                               # (N, F)
        f_ar = torch.arange(self.F, device=self.device)[None]
        one = torch.ones((), dtype=self.dtype, device=self.device)
        na = ~self.observed[None]
        lh0 = t["p"][:, f_ar, feat]                                          # (B, N, F)
        if inv_t is not None:
            it = torch.as_tensor(np.asarray(inv_t), device=self.device).to(self.dtype)
            lh0 = lh0.clamp(min=TINY) ** it[:, None, None]
        lhs = [torch.where(na, one, lh0)]
        for i in range(self.C - 1):
            g = self.group_of[i].clamp(min=0)[:, None]                        # (N, 1)
            lhs.append(torch.where(na, one, t["conf"][:, i][:, g, f_ar, feat]))
        lh = torch.stack(lhs, -1)                                            # (B, N, F, C)
        wh = t["wh"][:, None]                                                # (B, 1, F, C)

        def mix(h):
            h = h[:, :, None, :]
            return (wh * h * lh).sum(-1), (wh * h).sum(-1)

        s_cur, z_cur = mix(t["hc"])
        s_flip, z_flip = mix(t["hcf"])
        r = (s_cur / s_flip.clamp(min=TINY)) * (z_flip / z_cur.clamp(min=TINY))
        lr = torch.log(r.clamp(min=TINY)).sum(-1)
        return torch.where(t["incl"] > 0.5, lr, -lr).double().cpu().numpy().reshape(B, self.N)
