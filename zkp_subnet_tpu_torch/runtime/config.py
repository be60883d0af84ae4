"""Configuration surface, flag-name parity with the reference.

The port's own copy of ``zkp_subnet_tpu/runtime/config.py``.

The reference assembles a three-tier argparse config (reference:
utils/config.py:61-287): common prover/neuron flags, miner extras, validator
extras, all dotted (``--neuron.sample_size``). Here the same knobs are plain
dataclasses (mesh-native runtime needs no wallet/subtensor groups), plus an
argparse helper that accepts the same dotted flag names.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ProverConfig:
    """Prover/SRS knobs (reference: utils/config.py:124-170)."""
    scale: int = 18                   # log2 circuit size (mainnet 24)
    machines_scale: int = 8           # log2 worker count
    setup_path: str = "./setup"
    precompute_path: str = "./precompute"
    uncompressed: bool = False        # point wire format (config.py:131-136)


@dataclasses.dataclass
class WorkerConfig:
    """Miner-side knobs (reference: utils/config.py:174-210)."""
    prover: ProverConfig = dataclasses.field(default_factory=ProverConfig)
    name: str = "miner"
    force_validator_permit: bool = True       # blacklist.force_validator_permit
    allow_non_registered: bool = False        # blacklist.allow_non_registered


@dataclasses.dataclass
class CoordinatorConfig:
    """Validator-side knobs (reference: utils/config.py:213-287).

    ``timeout`` defaults to the 30 s the reference actually uses — its
    ``neuron.timeout`` flag (default 10) is dead config; query() hardcodes
    30.0 (reference: neurons/validator.py:206). We make the flag live.
    """
    prover: ProverConfig = dataclasses.field(default_factory=ProverConfig)
    name: str = "validator"
    timeout: float = 30.0
    sample_size: int = 20
    num_concurrent_forwards: int = 1
    moving_average_alpha: float = 0.1
    epoch_length: int = 100
    disable_set_weights: bool = False
    vpermit_tao_limit: float = 4096.0
    state_dir: str = "./state"


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--machines_scale", "--machines-scale", type=int, default=8)
    p.add_argument("--setup_path", "--setup-path", default="./setup")
    p.add_argument("--precompute_path", "--precompute-path",
                   default="./precompute")
    p.add_argument("--uncompressed", action="store_true")


def add_worker_args(p: argparse.ArgumentParser) -> None:
    _add_common(p)
    p.add_argument("--neuron.name", dest="name", default="miner")
    p.add_argument("--blacklist.force_validator_permit",
                   dest="force_validator_permit", action="store_true",
                   default=True)
    p.add_argument("--blacklist.allow_non_registered",
                   dest="allow_non_registered", action="store_true",
                   default=False)


def add_coordinator_args(p: argparse.ArgumentParser) -> None:
    _add_common(p)
    p.add_argument("--neuron.name", dest="name", default="validator")
    p.add_argument("--neuron.timeout", dest="timeout", type=float,
                   default=30.0)
    p.add_argument("--neuron.sample_size", dest="sample_size", type=int,
                   default=20)
    p.add_argument("--neuron.num_concurrent_forwards",
                   dest="num_concurrent_forwards", type=int, default=1)
    p.add_argument("--neuron.moving_average_alpha",
                   dest="moving_average_alpha", type=float, default=0.1)
    p.add_argument("--neuron.epoch_length", dest="epoch_length", type=int,
                   default=100)
    p.add_argument("--neuron.disable_set_weights",
                   dest="disable_set_weights", action="store_true")
    p.add_argument("--neuron.vpermit_tao_limit", dest="vpermit_tao_limit",
                   type=float, default=4096.0)
    p.add_argument("--neuron.state_dir", dest="state_dir", default="./state")


def _prover_from_ns(ns: argparse.Namespace) -> ProverConfig:
    return ProverConfig(scale=ns.scale, machines_scale=ns.machines_scale,
                        setup_path=ns.setup_path,
                        precompute_path=ns.precompute_path,
                        uncompressed=ns.uncompressed)


def worker_config(ns: argparse.Namespace) -> WorkerConfig:
    return WorkerConfig(prover=_prover_from_ns(ns), name=ns.name,
                        force_validator_permit=ns.force_validator_permit,
                        allow_non_registered=ns.allow_non_registered)


def coordinator_config(ns: argparse.Namespace) -> CoordinatorConfig:
    return CoordinatorConfig(
        prover=_prover_from_ns(ns), name=ns.name, timeout=ns.timeout,
        sample_size=ns.sample_size,
        num_concurrent_forwards=ns.num_concurrent_forwards,
        moving_average_alpha=ns.moving_average_alpha,
        epoch_length=ns.epoch_length,
        disable_set_weights=ns.disable_set_weights,
        vpermit_tao_limit=ns.vpermit_tao_limit,
        state_dir=ns.state_dir)
