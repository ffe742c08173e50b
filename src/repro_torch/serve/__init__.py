"""Serving: the forest inference server (`engine.ForestServer`) and the LM
server (`engine.prefill_step`, `decode_step`, `BatchedServer`)."""
