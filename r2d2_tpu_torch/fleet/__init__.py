"""The fleet's replay plane, the JAX package's ``fleet/`` first part:
``replay_service`` (N addressable device replay shards behind one
interface, with a host spill tier and a socket rung for remote
producers) and ``service_main`` (the service as a process of its own,
with its snapshots). Membership, the fan-out tree and promotion are
ROADMAP A.6's second part."""

from r2d2_tpu_torch.fleet.replay_service import (RemoteReplayProducer,
                                                 ReplayProducerPump,
                                                 ReplayService,
                                                 ReplayServiceServer,
                                                 ReplayShard, SpillTier,
                                                 build_service)

__all__ = ["ReplayService", "ReplayShard", "SpillTier",
           "ReplayServiceServer", "RemoteReplayProducer",
           "ReplayProducerPump", "build_service"]
