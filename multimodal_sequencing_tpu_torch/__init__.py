"""PyTorch/CUDA port of `multimodal_sequencing_tpu`.

The module layout mirrors the JAX package: each file here has its
counterpart at the same relative path there. The port imports `torch`
and nothing of JAX or of the JAX package; host modules it needs (tokenizer,
packer, decoders, metrics) are kept as copies, each pinned to its original
by a test in `tests/test_torch_*.py`.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU; without a card and without that request they raise.
"""

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on. The CPU is used only when asked
    for; a CUDA request without a card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev
