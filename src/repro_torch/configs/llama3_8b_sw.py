"""llama3-8b-sw8k [dense variant] — llama3-8b with an 8192-token sliding
window, making the long_500k decode shape runnable for a dense arch
(DESIGN.md §5: "dense archs only if you implement a sliding-window ...
variant").  Beyond-assignment extra config; the canonical llama3-8b entry
is unchanged.
"""
import dataclasses

from repro_torch.configs.base import register
from repro_torch.configs.llama3_8b import CONFIG as _BASE

CONFIG = register(dataclasses.replace(
    _BASE, name="llama3-8b-sw8k", sliding_window=8192))
