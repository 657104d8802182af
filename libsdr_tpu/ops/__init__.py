"""DSP ops (reference layers L3-L5, SURVEY.md sections 2.2-2.4).

Every op is a :class:`~libsdr_tpu.core.block.Processor` operating on blocks
with time on the trailing axis, plus (where useful) a plain functional form.
"""

from libsdr_tpu.ops import firdesign
from libsdr_tpu.ops.fir import FIRFilter, fir_overlap_save
from libsdr_tpu.ops.nco import FreqShift
from libsdr_tpu.ops.baseband import IQBaseBand
from libsdr_tpu.ops.demod import AMDemod, USBDemod, FMDemod, FMDeemph
from libsdr_tpu.ops.iir import iir_first_order
from libsdr_tpu.ops.resample import SubSample, FracSubSample, InpolSubSampler
from libsdr_tpu.ops.agc import AGC
from libsdr_tpu.ops.utils import (
    Scale, Cast, ToComplex, RealPart, ImagPart, IQBalance,
    UnsignedToSigned, SignedToUnsigned, Interleave,
)
from libsdr_tpu.ops.siggen import sine, iq_carrier, gaussian_noise
from libsdr_tpu.ops.fsk import FSKDetector, ASKDetector
from libsdr_tpu.ops.bitsync import BitStream
from libsdr_tpu.ops.psk31 import BPSK31
from libsdr_tpu.ops.baseband import BaseBand
from libsdr_tpu.ops.fft import fft
from libsdr_tpu.ops.fftfilter import FFTFilterBank
from libsdr_tpu.ops.channelizer import Channelizer
from libsdr_tpu.ops.fixedpoint import (FMDemodInt, FMDeemphInt,
                                        IQBaseBandInt, fast_atan2_i16)
from libsdr_tpu.ops.debug import BitDump, DebugStore, TextDump
from libsdr_tpu.ops.utils import AutoCast, Deinterleave

__all__ = [
    "FSKDetector", "ASKDetector", "BitStream", "BPSK31", "BaseBand",
    "fft", "FFTFilterBank", "Channelizer", "FMDemodInt",
    "FMDeemphInt", "IQBaseBandInt", "fast_atan2_i16",
    "BitDump", "DebugStore", "TextDump", "AutoCast", "Deinterleave",
    "firdesign", "FIRFilter", "fir_overlap_save", "FreqShift", "IQBaseBand",
    "AMDemod", "USBDemod", "FMDemod", "FMDeemph", "iir_first_order",
    "SubSample", "FracSubSample", "InpolSubSampler", "AGC",
    "Scale", "Cast", "ToComplex", "RealPart", "ImagPart", "IQBalance",
    "UnsignedToSigned", "SignedToUnsigned", "Interleave",
    "sine", "iq_carrier", "gaussian_noise",
]
