"""Federated population engine, ported so far: the synchronous runtime.

  population.py — `Population`: the base dataset once + per-client index
                  arrays and per-client persistent state, incl.
                  personalized tails.
  sampler.py    — `ClientSampler` (a copy): cohort draws, pure functions
                  of (seed, round).
  scheduler.py  — `RoundScheduler` + `StragglerConfig` (a copy):
                  stragglers, deadlines, dropouts -> participation arrays.
  engine.py     — `FederatedEngine`: the sample -> gather -> schedule ->
                  train -> checkpoint loop, resumable byte-identically.

The buffered async runtime and the edge topology are slice E.
"""
from repro_torch.fed.engine import FederatedEngine  # noqa: F401
from repro_torch.fed.population import Population  # noqa: F401
from repro_torch.fed.sampler import SAMPLER_KINDS, ClientSampler  # noqa: F401
from repro_torch.fed.scheduler import (  # noqa: F401
    LINK_REGIMES, FullParticipationScheduler, RoundPlan, RoundScheduler,
    StragglerConfig)
