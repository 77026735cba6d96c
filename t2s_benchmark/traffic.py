"""The traffic generator: every input a cell sends, made on the device from the seed.

A mix file (``traffic/<name>.json``) gives what belongs to the traffic: the
driver that runs it, the request batch, the caption lengths, the sampling
string. What the configuration states (the tokenizer's vocabulary and
context, the mel shape, a training batch) is read from the configuration.
The same seed gives the same inputs in the same order.
"""

import torch

SOT, EOT = 49406, 49407     # CLIP's start and end of text


def streams(seed: int, device, n: int):
    """``n`` independent generators on ``device`` derived from ``seed``."""
    root = torch.Generator("cpu").manual_seed(int(seed))
    return [torch.Generator(device).manual_seed(
        int(torch.randint(0, 2**62, (1,), generator=root))) for _ in range(n)]


def tokenizer(config: dict) -> dict:
    """The configuration's text tokenizer: {"vocab_end", "context"}."""
    tok = config["model"]["params"]["condition_codec_config"]["params"]
    return {"vocab_end": tok["tokenizer_config"]["params"]["end_idx"],
            "context": tok["context_length"]}


def caption_ids(gen: torch.Generator, batch: int, lengths, vocab_end: int, context: int):
    """(batch, context) int32 BPE ids on the generator's device: SOT, a caption of
    ``lengths`` = [lo, hi] ids in [1, ``vocab_end``), EOT, then 0."""
    lo, hi = lengths
    dev = gen.device
    n = torch.randint(lo, hi + 1, (batch, 1), generator=gen, device=dev)
    body = torch.randint(1, vocab_end, (batch, context), generator=gen, device=dev)
    pos = torch.arange(context, device=dev)[None, :]
    ids = torch.where(pos <= n, body, 0)
    ids = torch.where(pos == n + 1, EOT, ids)
    ids[:, 0] = SOT
    return ids.to(torch.int32)


def mels(gen: torch.Generator, batch: int, n_mels: int, frames: int, loudness=None):
    """(batch, n_mels, frames, 1) float32 mels in [-1, 1]: uniform noise
    smoothed over time, so the codec sees spectrogram-like structure. With
    ``loudness`` = [lo, hi] each clip's level above the floor (-1) is scaled
    from lo at the batch's first clip evenly to hi at its last: every batch
    holds quiet and loud clips, and no half of it stands for the whole."""
    x = torch.rand((batch, 1, n_mels, frames + 8), generator=gen, device=gen.device)
    x = torch.nn.functional.avg_pool2d(x, (1, 9), stride=1)
    x = (x - x.amin(dim=(2, 3), keepdim=True)) / (x.amax(dim=(2, 3), keepdim=True)
                                                  - x.amin(dim=(2, 3), keepdim=True))
    if loudness is not None:
        lo, hi = loudness
        x = x * torch.linspace(lo, hi, batch, device=gen.device).view(batch, 1, 1, 1)
    return (2 * x - 1).permute(0, 2, 3, 1).contiguous()
