"""Speech (ASR/TTS) boundary — external Riva services, import-gated (a
copy of the reference package's ``frontend/speech.py``).

Parity with the reference's speech layer (reference:
frontend/frontend/asr_utils.py — Riva gRPC streaming speech-to-text into
the message box; tts_utils.py — text-to-speech of responses, with
language/voice discovery from the server config). Riva stays an external
service boundary (SURVEY.md §2 native-component 11: out of scope to
reimplement the speech models); these classes wrap its gRPC API when the
``riva.client`` package is present and degrade to a clear error when not.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..utils.errors import ConfigError


def _require_riva():
    try:
        import riva.client  # type: ignore
        return riva.client
    except ImportError as exc:
        raise ConfigError(
            "speech features require the 'nvidia-riva-client' package and a "
            "running Riva server (external boundary, like the reference); "
            "install riva-client and set the server URI") from exc


class ASRClient:
    """Streaming speech-to-text (reference: asr_utils.py ``ASRSession``)."""

    def __init__(self, server: str = "localhost:50051",
                 language_code: str = "en-US", sample_rate_hz: int = 16000):
        riva = _require_riva()
        self._auth = riva.Auth(uri=server)
        self._service = riva.ASRService(self._auth)
        self._riva = riva
        self.language_code = language_code
        self.sample_rate_hz = sample_rate_hz

    def transcribe_streaming(self, audio_chunks: Iterator[bytes],
                             ) -> Iterator[str]:
        """Yield partial transcripts for streaming audio
        (reference: asr_utils.py ``transcribe_streaming``)."""
        riva = self._riva
        config = riva.StreamingRecognitionConfig(
            config=riva.RecognitionConfig(
                language_code=self.language_code,
                sample_rate_hertz=self.sample_rate_hz,
                max_alternatives=1, enable_automatic_punctuation=True),
            interim_results=True)
        for response in self._service.streaming_response_generator(
                audio_chunks, config):
            for result in response.results:
                if result.alternatives:
                    yield result.alternatives[0].transcript

    def transcribe(self, audio: bytes) -> str:
        """Offline recognition of a complete recording (the converse
        page's mic posts one 16 kHz LINEAR_PCM WAV): all final segments
        concatenated — a multi-utterance recording keeps every sentence,
        not just the last recognizer yield."""
        riva = self._riva
        config = riva.RecognitionConfig(
            encoding=riva.AudioEncoding.LINEAR_PCM,
            language_code=self.language_code,
            sample_rate_hertz=self.sample_rate_hz,
            max_alternatives=1, enable_automatic_punctuation=True)
        response = self._service.offline_recognize(audio, config)
        return " ".join(
            r.alternatives[0].transcript.strip()
            for r in response.results if r.alternatives).strip()


class TTSClient:
    """Text-to-speech (reference: tts_utils.py ``text_to_speech``)."""

    def __init__(self, server: str = "localhost:50051",
                 language_code: str = "en-US",
                 voice_name: Optional[str] = None,
                 sample_rate_hz: int = 44100):
        riva = _require_riva()
        self._auth = riva.Auth(uri=server)
        self._service = riva.SpeechSynthesisService(self._auth)
        self.language_code = language_code
        self.voice_name = voice_name
        self.sample_rate_hz = sample_rate_hz

    def synthesize(self, text: str) -> bytes:
        resp = self._service.synthesize(
            text, voice_name=self.voice_name,
            language_code=self.language_code,
            sample_rate_hz=self.sample_rate_hz)
        return resp.audio
