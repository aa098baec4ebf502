"""audioflow_tpu — an audio DSP flow-graph framework on JAX/XLA.

A ground-up JAX/XLA rebuild of the capabilities of audio-flow-rs
(reference surveyed in SURVEY.md): host decode feeds HBM-resident sample
batches through flow-graphs of transform nodes (resample, biquad EQ, STFT,
mel, gain, VAD, quantize, phase vocoder) compiled to a single jitted XLA
program per graph, vmapped over file batches and sharded across devices.
"""

from .version import __version__

__all__ = ["__version__", "ops"]

from . import ops  # noqa: E402
