"""Audio transcription via Groq's Whisper endpoint (raw REST over httpx;
behavioral equivalent of reference server/web/utils/transcribe.py, which
uses the groq SDK — not available in this image)."""

from __future__ import annotations

import os
from typing import Optional

import httpx

GROQ_TRANSCRIPTION_URL = "https://api.groq.com/openai/v1/audio/transcriptions"
DEFAULT_MODEL = "whisper-large-v3-turbo"


def transcribe_audio(
    audio_path: str,
    language: Optional[str] = None,
    *,
    api_key: Optional[str] = None,
    model: str = DEFAULT_MODEL,
    transport: Optional[httpx.BaseTransport] = None,
    timeout: float = 120.0,
) -> str:
    """Transcribe an audio file; raises RuntimeError on failure or empty
    text (matching the reference's contract, transcribe.py:24-25)."""
    api_key = api_key or os.environ.get("GROQ_API_KEY", "")
    data = {"model": model, "response_format": "json"}
    if language:
        data["language"] = language
    try:
        with open(audio_path, "rb") as f:
            with httpx.Client(timeout=timeout, transport=transport) as client:
                resp = client.post(
                    GROQ_TRANSCRIPTION_URL,
                    headers={"Authorization": f"Bearer {api_key}"},
                    data=data,
                    files={"file": (os.path.basename(audio_path), f)},
                )
    except Exception as e:
        raise RuntimeError(f"Groq transcription error: {e}") from e
    if resp.status_code != 200:
        raise RuntimeError(f"Groq transcription error: {resp.text}")
    text = resp.json().get("text")
    if not text:
        raise RuntimeError("Empty transcription returned")
    return text
