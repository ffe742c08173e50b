"""Test-support utilities shipped with the port (not test code).

`repro_torch.testing.faults` is the fault-injection harness for streamed
training: flaky and dead chunk reads, and SIGKILL at a chosen moment.
"""
