"""Traffic kinds: one module each, named by a traffic file's ``kind``,
holding the class of that name (capitalised) that sets a cell up from the
seed, runs one unit of work at a time and checks the answers."""


def sync(device):
    """Wait for the device's queued work (a no-op off the card)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
