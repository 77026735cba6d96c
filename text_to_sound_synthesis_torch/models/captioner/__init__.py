from .model import ACTCaptioner, AudioPatchEncoder, beam_decode, greedy_decode  # noqa: F401
