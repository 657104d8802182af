"""libsdr_tpu — a JAX software-defined-radio framework for accelerators.

A from-scratch JAX/XLA re-design of the capabilities of hmatuschek/libsdr
(reference mounted at /root/reference). The reference is a pthread push-dataflow
graph of stateful per-sample C++ nodes (reference: src/node.hh, src/queue.cc);
this framework instead models a radio pipeline as a *pure function over
fixed-size time blocks*::

    step(carry, block) -> (carry, out_block)

with all per-node state (FIR tails, NCO phase, PLL state, decoder shift
registers) held in an explicit ``carry`` pytree.  The whole pipeline is jitted
once and sharded over a ``jax.sharding.Mesh`` (channels x time-blocks), with
overlap-save filter halos exchanged via collectives.

Layer map (mirrors SURVEY.md section 1):

- :mod:`libsdr_tpu.core`   — stream metadata, processor protocol, pipeline
  builder, host streaming driver (reference: src/node.hh, src/queue.hh).
- :mod:`libsdr_tpu.ops`    — DSP blocks: FIR/IIR, NCO shift, baseband
  select+decimate, resamplers, AGC, demodulators, FFT fast-convolution,
  polyphase channelizer (reference: src/firfilter.hh, src/baseband.hh, ...).
- :mod:`libsdr_tpu.decode` — digital decoders: bit-sync PLL, FSK/ASK, PSK31,
  POCSAG+BCH(31,21), AX.25/APRS, Baudot (reference: src/fsk.hh, src/pocsag.hh,
  src/ax25.hh, src/aprs.hh, src/baudot.hh, src/psk31.hh).
- :mod:`libsdr_tpu.io`     — WAV and raw-sample file I/O (reference:
  src/wavfile.hh, src/utils.hh StreamSource/StreamSink).
- :mod:`libsdr_tpu.parallel` — mesh/sharding helpers, halo exchange,
  multi-chip channelizer (no referent in the reference; see SURVEY.md 2.9).
- :mod:`libsdr_tpu.utils`  — logging, CLI options (reference: src/logger.hh,
  src/options.hh).
"""

__version__ = "0.1.0"

from libsdr_tpu.core.stream import StreamSpec  # noqa: F401
from libsdr_tpu.core.block import Processor  # noqa: F401
from libsdr_tpu.core.graph import Pipeline  # noqa: F401
