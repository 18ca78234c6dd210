"""Import a stable-baselines3 PPO checkpoint as the port's ActorCritic.

Counterpart of `drone2d_tpu/compat/sb3_import.py`.  The reference ships its
trained agents as SB3 `.zip` archives (saved by `main.py:209` / SB3's
CheckpointCallback); each holds a `policy.pth` torch state dict of the
MlpPolicy:

    log_std                                          (2,)
    mlp_extractor.policy_net.{0,2}.{weight,bias}     27->H->H tanh trunk
    mlp_extractor.value_net.{0,2}.{weight,bias}      27->H->H tanh trunk
    action_net.{weight,bias}                         H->2 mean head
    value_net.{weight,bias}                          H->1 value head

That is the layout of `models/policy.ActorCritic`; torch's Linear stores
its weight (out, in) and the port's Dense (in, out), so each matrix is
transposed on the way in.  Loading needs only `zipfile` and torch, not SB3.

    python -m drone2d_tpu_torch.compat.sb3_import PFCA_see_3_obs_17_90.zip \\
        --out agent_17_90.npz --verify

writes the `.npz` naming of the agent files (`params_to_flat_dict`), which
both packages' `load_params` read; `--verify` holds the port's forward (the
fused kernel on the card, unless `--device cpu`) against
`torch_policy_value`.  `save_sb3_zip` writes an agent file back as such a
zip.
"""

from __future__ import annotations

import io
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch

from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params


def load_sb3_state_dict(zip_path: str) -> Dict[str, np.ndarray]:
    """`policy.pth` of an SB3 zip as float32 numpy arrays."""
    with zipfile.ZipFile(zip_path) as z:
        buf = io.BytesIO(z.read("policy.pth"))
    sd = torch.load(buf, map_location="cpu", weights_only=True)
    return {k: v.detach().numpy().astype(np.float32) for k, v in sd.items()}


def save_sb3_zip(flat: Dict[str, np.ndarray], zip_path: str) -> None:
    """Write an agent (the flat dict of an agent `.npz`) as an SB3 zip whose
    `policy.pth` holds the MlpPolicy state dict, weights (out, in): the
    inverse of `load_sb3_agent`."""
    sd = {"log_std": flat["log_std"]}
    for net, name in (("policy_net", "pi"), ("value_net", "vf")):
        i = 0
        while f"{name}{i}/w" in flat:
            sd[f"mlp_extractor.{net}.{2 * i}.weight"] = np.asarray(flat[f"{name}{i}/w"]).T
            sd[f"mlp_extractor.{net}.{2 * i}.bias"] = flat[f"{name}{i}/b"]
            i += 1
    for head, name in (("action_net", "pi_out"), ("value_net", "vf_out")):
        sd[f"{head}.weight"] = np.asarray(flat[f"{name}/w"]).T
        sd[f"{head}.bias"] = flat[f"{name}/b"]
    buf = io.BytesIO()
    torch.save({k: torch.tensor(np.array(v, np.float32)) for k, v in sd.items()}, buf)
    with zipfile.ZipFile(zip_path, "w") as z:
        z.writestr("policy.pth", buf.getvalue())


def _flat_trunk(sd: Dict[str, np.ndarray], net: str, name: str) -> dict:
    """`mlp_extractor.<net>`'s Linear layers (at the even indices of SB3's
    Sequential(Linear, Tanh, ...)) in the agent-file naming, (in, out)."""
    out, i = {}, 0
    while f"mlp_extractor.{net}.{i}.weight" in sd:
        out[f"{name}{i // 2}/w"] = sd[f"mlp_extractor.{net}.{i}.weight"].T
        out[f"{name}{i // 2}/b"] = sd[f"mlp_extractor.{net}.{i}.bias"]
        i += 2
    if not out:
        raise ValueError(f"no mlp_extractor.{net} layers found in state dict")
    return out


def params_from_state_dict(sd: Dict[str, np.ndarray], device=None) -> ActorCritic:
    """An SB3 MlpPolicy state dict -> ActorCritic on `device` (the card
    unless device="cpu"), at whatever trunk widths it has."""
    flat = {**_flat_trunk(sd, "policy_net", "pi"), **_flat_trunk(sd, "value_net", "vf"),
            "pi_out/w": sd["action_net.weight"].T, "pi_out/b": sd["action_net.bias"],
            "vf_out/w": sd["value_net.weight"].T, "vf_out/b": sd["value_net.bias"],
            "log_std": sd["log_std"]}
    return flat_dict_to_params(flat, device=device)


def load_sb3_agent(zip_path: str, device=None) -> ActorCritic:
    """SB3 PPO zip -> ActorCritic, ready for eval.run or a train warm start."""
    return params_from_state_dict(load_sb3_state_dict(zip_path), device=device)


def torch_policy_value(
    sd: Dict[str, np.ndarray], obs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The forward pass straight off the state dict, in numpy float32:
    (action mean (B, 2), value (B,)), independent of `models/policy.py`."""

    def mlp(x, net):
        i = 0
        while f"mlp_extractor.{net}.{i}.weight" in sd:
            x = np.tanh(x @ sd[f"mlp_extractor.{net}.{i}.weight"].T
                        + sd[f"mlp_extractor.{net}.{i}.bias"])
            i += 2
        return x

    mean = mlp(obs, "policy_net") @ sd["action_net.weight"].T + sd["action_net.bias"]
    value = (mlp(obs, "value_net") @ sd["value_net.weight"].T + sd["value_net.bias"])[..., 0]
    return mean, value


def main(argv=None) -> None:
    """CLI: SB3 PPO zip -> agent .npz (`--init-params` of the train CLIs,
    `--agent` of eval.run)."""
    import argparse
    import os

    from drone2d_tpu_torch.models.policy import params_to_flat_dict

    p = argparse.ArgumentParser(
        description="Import a reference SB3 PPO checkpoint (.zip) as an agent .npz.")
    p.add_argument("zip_path")
    p.add_argument("--out", required=True)
    p.add_argument("--verify", action="store_true",
                   help="hold the port's forward pass against a numpy evaluation of "
                   "the original weights")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where --verify runs the port's forward; the default is the "
                   "CUDA card ('cpu' runs on the host)")
    args = p.parse_args(argv)

    sd = load_sb3_state_dict(args.zip_path)
    params = params_from_state_dict(sd, device=args.device)
    if args.verify:
        rng = np.random.default_rng(0)
        obs = rng.standard_normal((256, params.pi[0].w.shape[0])).astype(np.float32)
        mean_ref, value_ref = torch_policy_value(sd, obs)
        # the sampled action at zero noise is the mean: the fused kernel on
        # the card, its plain version on the CPU
        x = torch.as_tensor(obs, device=params.log_std.device)
        mean, _, value = params.sample_action(x, noise=torch.zeros_like(x[:, :2]))
        err_m = float(np.max(np.abs(mean.cpu().numpy() - mean_ref)))
        v_scale = max(float(np.max(np.abs(value_ref))), 1.0)
        err_v = float(np.max(np.abs(value.cpu().numpy() - value_ref))) / v_scale
        print(f"verify: max|mean diff| {err_m:.3e}  max rel|value diff| {err_v:.3e}")
        if not (err_m < 1e-5 and err_v < 1e-5):
            raise AssertionError("transplant mismatch")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **params_to_flat_dict(params))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
