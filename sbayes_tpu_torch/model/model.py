"""Model facade: data + config -> constants on a device and the posterior.

Port of ``sbayes_tpu/model/model.py``; ``likelihood`` / ``prior`` /
``parts`` evaluate a batch of chain states.
"""
from __future__ import annotations

from sbayes_tpu_torch.config.schema import ModelConfig
from sbayes_tpu_torch.data.loader import Data
from sbayes_tpu_torch.model.constants import ModelConstants, build_model_constants
from sbayes_tpu_torch.model.posterior import Posterior


class Model:
    def __init__(self, data: Data, config: ModelConfig, n_clusters=None, device="cuda"):
        self.data = data
        self.config = config
        self.confounders = data.confounders
        self.consts: ModelConstants = build_model_constants(data, config, n_clusters=n_clusters,
                                                            device=device)
        self.device = self.consts.device
        self.shapes = self.consts.shapes
        self.n_clusters = self.shapes.n_clusters
        self.min_size = self.consts.min_size
        self.max_size = self.consts.max_size
        self.posterior = Posterior(self.consts)

    def likelihood(self, state):
        return self.posterior.parts(state).log_lh

    def prior(self, state):
        return self.posterior.parts(state).log_prior

    def parts(self, state):
        return self.posterior.parts(state)

    def __call__(self, state):
        p = self.posterior.parts(state)
        return p.log_lh + p.log_prior

    def get_setup_message(self) -> str:
        c = self.consts
        msg = "\nModel\n##########################################\n"
        msg += f"Number of clusters: {self.n_clusters}\n"
        msg += f"Clusters have a minimum size of {c.min_size} and a maximum size of {c.max_size}\n"
        msg += f"Geo-prior: {c.geo.prior_type}\n"
        msg += f"Prior on cluster size: {c.size_prior_type}\n"
        msg += f"Prior on weights: {'uniform' if c.weights_prior_uniform else 'dirichlet'}\n"
        msg += f"Device: {c.device}\n"
        return msg
