"""Application CLIs mirroring the reference's examples (reference layer L9:
examples/sdr_wavplay, sdr_fm, sdr_rec, sdr_rtty, sdr_pocsag, sdr_ax25 and the
cmd/ APRS web app).

Accelerator servers have neither a sound card (PortAudio) nor an RTL2832 dongle, so
audio output becomes a WAV file / stdout and live ingest becomes file or raw
capture input; everything else is chain-for-chain the same.

Run as modules, e.g.::

    python -m libsdr_tpu.apps.fm_rx --file capture.wav -o audio.wav
    python -m libsdr_tpu.apps.pocsag_rx --raw rtl.bin --rate 1000000 -F 0
    python -m libsdr_tpu.apps.aprs_service --file aprs.wav --port 8080
"""
