from sar_tpu_torch.decode.beam import beam_decode  # noqa: F401
from sar_tpu_torch.decode.greedy import (  # noqa: F401
    greedy_decode,
    greedy_decode_from_cache,
    transcribe_tokens,
)
