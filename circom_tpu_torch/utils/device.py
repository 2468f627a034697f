"""Device selection: the port runs on the card unless asked for the CPU."""

import torch


def resolve_device(device="cuda"):
    """torch.device for `device`; "cuda" needs a card and raises without
    one (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' (--device cpu) "
                "to run the plain version on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
