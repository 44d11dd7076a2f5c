"""Device resolution and numeric settings for the port.

``cuda`` is the default device.  Asking for it on a machine without a
usable card raises: nothing in the port moves work to the CPU because it
found no GPU.  The CPU is taken only when it is asked for by name (the
CPU tests, and re-threading checks).

The JAX package scores at ``Precision.HIGHEST`` (true fp32 matmuls).
On an NVIDIA card a float32 matmul may run in TF32, which keeps ~3
decimal digits and drifts the pair scores enough to flip cluster-editing
decisions, so the port pins true fp32 before any device work.
"""

from __future__ import annotations

import torch


def set_true_fp32() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp32_settings() -> dict:
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def resolve_device(name: "str | torch.device" = "cuda") -> torch.device:
    """``"cuda"`` (default), ``"cuda:N"`` or ``"cpu"`` -> torch.device.

    Raises RuntimeError for a CUDA device when no card is available."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    set_true_fp32()
    return dev


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line(dev: torch.device):
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (raises when nvidia-smi fails), or None for the CPU.  A measurement
    carries it, since a card set below its limit runs slower."""
    if dev.type != "cuda":
        return None
    import subprocess

    index = dev.index if dev.index is not None else 0
    out = subprocess.run(["nvidia-smi", f"--id={index}",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]

