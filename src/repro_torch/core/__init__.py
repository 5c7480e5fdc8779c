"""Auxo's core (port of ``repro.core``): gradient sketches, online
clustering, rewards and selection, the cohort tree, partition criteria and
the coordinator."""
from repro_torch.core.clustering import (
    ClusterState,
    OnlineClustering,
    assign_and_update,
    assign_and_update_batched,
    kmeans_bootstrap_batched,
    kmeans_cosine,
    population_heterogeneity,
)
from repro_torch.core.cohort import CohortTree, distance_matrix, tree_distance
from repro_torch.core.coordinator import CohortCoordinator, PartitionEvent
from repro_torch.core.criteria import PartitionCriteria
from repro_torch.core.selection import (
    CohortSelector,
    instant_reward,
    instant_reward_batched,
    update_rewards,
)
from repro_torch.core.sketch import GradientSketcher

__all__ = [
    "ClusterState",
    "CohortCoordinator",
    "CohortSelector",
    "CohortTree",
    "GradientSketcher",
    "OnlineClustering",
    "PartitionCriteria",
    "PartitionEvent",
    "assign_and_update",
    "assign_and_update_batched",
    "distance_matrix",
    "instant_reward",
    "instant_reward_batched",
    "kmeans_bootstrap_batched",
    "kmeans_cosine",
    "population_heterogeneity",
    "tree_distance",
    "update_rewards",
]
