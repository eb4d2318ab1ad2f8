"""Federated population engine — the port of `repro/fed/`: N >> K clients,
sampled cohorts, stragglers, resumable rounds, and the two runtimes beside
the synchronous barrier.

  population.py — `Population`: the base dataset once + per-client index
                  arrays and per-client persistent state, incl.
                  personalized tails.
  sampler.py    — `ClientSampler` (a copy): cohort draws, pure functions
                  of (seed, round).
  scheduler.py  — `RoundScheduler` + `StragglerConfig` (a copy):
                  stragglers, deadlines, dropouts -> participation arrays.
  engine.py     — `FederatedEngine`: the sample -> gather -> schedule ->
                  train -> checkpoint loop, resumable byte-identically.
  topology.py   — `EdgeTopology` + `HierarchicalAggregator`: two-tier
                  (client -> edge -> global) aggregation with per-edge
                  secure-agg instances and metered backhaul bytes.
  buffer.py     — `DeltaBuffer` + `StalenessLedger` + staleness weights:
                  the bounded arrival buffer the async runtime flushes.
  async_engine.py — `AsyncRoundEngine` + `AsyncConfig`: barrier-free
                  buffered-async driver (FedBuff-style), clients on their
                  own simulated clocks, staleness-weighted flushes.
"""
from repro_torch.fed.async_engine import (  # noqa: F401
    AsyncConfig, AsyncRoundEngine)
from repro_torch.fed.buffer import (  # noqa: F401
    BufferEntry, DeltaBuffer, StalenessLedger, staleness_weight)
from repro_torch.fed.engine import FederatedEngine  # noqa: F401
from repro_torch.fed.population import Population  # noqa: F401
from repro_torch.fed.sampler import SAMPLER_KINDS, ClientSampler  # noqa: F401
from repro_torch.fed.scheduler import (  # noqa: F401
    LINK_REGIMES, FullParticipationScheduler, RoundPlan, RoundScheduler,
    StragglerConfig)
from repro_torch.fed.topology import (  # noqa: F401
    EdgeTopology, HierarchicalAggregator)
