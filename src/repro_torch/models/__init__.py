"""The LM scaffold: building blocks (`layers`), the decoder assembly
(`transformer`) and the mixer/FFN families (`moe`, `rwkv`, `mamba`),
ported from `repro.models` as plain torch ops."""
