"""Checkpoint and resume, the JAX package's ``runtime/checkpoint.py`` with
``torch.save`` in place of orbax.

A checkpoint holds the full training state: params, target params, the
optimizer's ``state_dict``, ``step``, ``env_steps`` and the replay
sampling generator's state. Checkpoint k of player p is the file
``{save_dir}/{game}{k}_player{p}`` (the reference's naming, without its
``.pth``), written atomically, with the training Config beside it in
``.config.json`` so evaluation rebuilds the exact network.
``load_pretrain`` is the weights-only warm start; ``apply_restore`` the
one resume/warm-start policy of the learner.
"""

import logging
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch


def _checkpoint_path(save_dir: str, game: str, index: int, player: int
                    ) -> str:
    return os.path.abspath(os.path.join(save_dir,
                                        f"{game}{index}_player{player}"))


def _cpu_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_checkpoint(save_dir: str, game: str, index: int, player: int,
                    train_state, env_steps: int,
                    config_json: Optional[str] = None,
                    generators: Optional[List[torch.Tensor]] = None) -> str:
    """Write ``train_state`` (a ``TrainState``) as checkpoint ``index``;
    returns its path. ``generators``: every data-parallel rank's sampling
    generator state, by rank (rank 0 writes the replicated state and
    these)."""
    path = _checkpoint_path(save_dir, game, index, player)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "params": _cpu_state(train_state.params),
        "target_params": _cpu_state(train_state.target_params),
        "opt_state": train_state.opt.state_dict(),
        "step": int(train_state.step),
        "env_steps": int(env_steps),
        "generator": train_state.generator.get_state(),
    }
    if generators is not None:
        payload["generators"] = list(generators)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if config_json is not None:
        with open(path + ".config.json", "w") as f:
            f.write(config_json)
    return path


def load_checkpoint_config(path: str):
    """The Config stored beside a checkpoint, or None."""
    cfg_path = os.path.abspath(path) + ".config.json"
    if not os.path.exists(cfg_path):
        return None
    from r2d2_tpu_torch.config import Config
    with open(cfg_path) as f:
        return Config.from_json(f.read())


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint's payload, its tensors on the CPU."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is a directory: an orbax checkpoint of the JAX "
            "package, which the port cannot read")
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_module(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                 path: str) -> None:
    """Copy a state dict into ``module``'s existing tensors (their
    addresses stay: a CUDA graph may read them later)."""
    own = module.state_dict()
    if own.keys() != state.keys():
        raise ValueError(
            f"checkpoint at {path!r} does not match the network's "
            f"parameters: missing {sorted(own.keys() - state.keys())[:4]}, "
            f"unexpected {sorted(state.keys() - own.keys())[:4]}")
    for name, t in own.items():
        if tuple(t.shape) != tuple(state[name].shape):
            raise ValueError(
                f"checkpoint param {name!r} has shape "
                f"{tuple(state[name].shape)}; the network expects "
                f"{tuple(t.shape)}: architecture mismatch (network config "
                "differs from the checkpoint's)")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(state[name])


FIRST_CONV = "torso.convs.0.weight"


def _maybe_migrate_space_to_depth(state: Dict[str, torch.Tensor],
                                  module: torch.nn.Module
                                  ) -> Dict[str, torch.Tensor]:
    """A standard-layout checkpoint for a ``network.space_to_depth="on"``
    network: the first conv's weight rewritten exactly
    (models/network.py ``convert_params_space_to_depth``), as the JAX
    package's ``_maybe_migrate_space_to_depth`` does. The reverse
    direction is refused: there is no automatic downgrade. Anything else
    is left for ``_load_module`` to judge."""
    own = module.state_dict().get(FIRST_CONV)
    got = state.get(FIRST_CONV)
    if own is None or got is None or own.shape == got.shape:
        return state
    to, tc, tkh, tkw = own.shape
    po, pc, pkh, pkw = got.shape
    if (tc, tkh, tkw) == (4 * pc, pkh // 2, pkw // 2) and to == po:
        from r2d2_tpu_torch.models.network import \
            convert_params_space_to_depth
        logging.getLogger(__name__).info(
            "pretrain checkpoint uses the standard first-conv layout; "
            "migrating it to space_to_depth (exact rewrite)")
        return convert_params_space_to_depth(state, frame_stack=pc)
    if (pc, pkh, pkw) == (4 * tc, tkh // 2, tkw // 2) and to == po:
        raise ValueError(
            "pretrain checkpoint uses the space_to_depth first-conv layout "
            "but the network has network.space_to_depth=off: set it to "
            "'on' (the transform is exact; there is no automatic "
            "downgrade)")
    return state


def load_pretrain(path: str, module: torch.nn.Module) -> None:
    """Weights-only warm start: the checkpoint's params into ``module``,
    a standard-layout checkpoint migrated into a space_to_depth network
    (exact rewrite)."""
    state = _maybe_migrate_space_to_depth(
        restore_checkpoint(path)["params"], module)
    _load_module(module, state, path)


def resume_training_state(path: str, train_state, rank: int = 0) -> int:
    """Full resume into ``train_state`` in place: params, target params,
    optimizer state, step and the sampling generator (data-parallel rank
    ``rank``'s, where the checkpoint holds every rank's; a rank the
    checkpoint has none for keeps its own). Returns env_steps. Call before
    the first step is captured: the optimizer's load replaces its state
    tensors."""
    restored = restore_checkpoint(path)
    _load_module(train_state.params, restored["params"], path)
    if train_state.target_params is not train_state.params:
        _load_module(train_state.target_params, restored["target_params"],
                     path)
    train_state.opt.load_state_dict(restored["opt_state"])
    train_state.step = int(restored["step"])
    train_state.step_count.fill_(train_state.step)
    generators = restored.get("generators")
    if generators is not None and rank < len(generators):
        state = generators[rank]
    elif rank == 0:
        state = restored["generator"]
    else:
        logging.getLogger(__name__).warning(
            "%s holds no sampling generator for rank %d; it keeps its own",
            path, rank)
        return int(restored["env_steps"])
    try:
        train_state.generator.set_state(state)
    except RuntimeError:
        # a generator of another device type keeps a state of another size
        logging.getLogger(__name__).warning(
            "%s: the sampling generator's state was saved on another device "
            "type and is not restored", path)
    return int(restored["env_steps"])


def apply_restore(runtime_cfg, train_state, rank: int = 0) -> int:
    """The one resume/warm-start policy: ``runtime.resume`` restores the
    full state (rank ``rank``'s generator), ``runtime.pretrain`` the
    weights (and copies them into the target); neither is a no-op.
    Returns the resumed env_steps."""
    if runtime_cfg.resume and runtime_cfg.pretrain:
        raise ValueError(
            "runtime.resume and runtime.pretrain are mutually exclusive: "
            "resume restores the full training state")
    if runtime_cfg.resume:
        return resume_training_state(runtime_cfg.resume, train_state, rank)
    if runtime_cfg.pretrain:
        load_pretrain(runtime_cfg.pretrain, train_state.params)
        if train_state.target_params is not train_state.params:
            train_state.target_params.load_state_dict(
                train_state.params.state_dict())
    return 0


def list_checkpoints(save_dir: str, game: str, player: int
                     ) -> List[Tuple[int, str]]:
    """Sorted (index, path) pairs: the evaluation sweep's order."""
    if not os.path.isdir(save_dir):
        return []
    pat = re.compile(re.escape(game) + r"(\d+)_player" + str(player) + r"$")
    out = []
    for name in os.listdir(save_dir):
        m = pat.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(save_dir, name)))
    return sorted(out)


def latest_checkpoint(save_dir: str, game: str, player: int
                      ) -> Optional[str]:
    ckpts = list_checkpoints(save_dir, game, player)
    return ckpts[-1][1] if ckpts else None


def prune_checkpoints(save_dir: str, game: str, player: int,
                      keep: int) -> List[str]:
    """Delete all but the newest ``keep`` checkpoints of one player, each
    with its ``.config.json``; ``keep <= 0`` keeps everything. Returns the
    pruned paths."""
    if keep <= 0:
        return []
    pruned = []
    for _idx, path in list_checkpoints(save_dir, game, player)[:-keep]:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.remove(path)
            except OSError:
                pass
        try:
            os.remove(path + ".config.json")
        except OSError:
            pass
        pruned.append(path)
    return pruned
