"""LM checkpoints: the reference's flat `.npz` key scheme (`io`)."""
