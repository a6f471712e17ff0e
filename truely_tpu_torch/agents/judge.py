"""LLM judge + search-query generation via the Gemini REST API.

Behavioral equivalent of reference server/web/utils/judge.py (which uses the
google-generativeai SDK — not in this image): temperature 0.2, JSON mime
type, markdown-fence stripping, brace repair, parse-failure stub verdict,
and the first-30-words fallback query capped at 350 chars.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import httpx

from truely_tpu_torch.agents.prompts import JUDGE_PROMPT, SEARCH_QUERY_PROMPT

GEMINI_URL_TEMPLATE = (
    "https://generativelanguage.googleapis.com/v1beta/models/{model}:generateContent"
)
DEFAULT_MODEL = "gemini-2.5-flash"
FALLBACK_QUERY_WORDS = 30
QUERY_MAX_CHARS = 350


def _generate(
    prompt_text: str,
    api_key: str,
    *,
    model: str,
    temperature: float,
    transport: Optional[httpx.BaseTransport],
    timeout: float,
) -> str:
    body = {
        "contents": [{"parts": [{"text": prompt_text}]}],
        "generationConfig": {
            "temperature": temperature,
            "responseMimeType": "application/json",
        },
    }
    with httpx.Client(timeout=timeout, transport=transport) as client:
        resp = client.post(
            GEMINI_URL_TEMPLATE.format(model=model),
            params={"key": api_key},
            json=body,
        )
    if resp.status_code != 200:
        raise RuntimeError(f"Gemini error: {resp.text}")
    data = resp.json()
    try:
        return data["candidates"][0]["content"]["parts"][0]["text"]
    except (KeyError, IndexError) as e:
        raise RuntimeError(f"Gemini error: malformed response: {data}") from e


def _clean_json_text(text: str) -> str:
    """Strip markdown fences and repair missing outer braces (the reference's
    defensive parsing, judge.py:29-40)."""
    text = text.strip()
    if text.startswith("```json"):
        text = text.replace("```json", "", 1).strip()
    elif text.startswith("```"):
        text = text.replace("```", "", 1).strip()
    if text.endswith("```"):
        text = text.rsplit("```", 1)[0].strip()
    text = text.strip()
    if not text.startswith("{"):
        text = "{" + text
    if not text.endswith("}"):
        text = text + "}"
    return text


def judge_content(
    transcript: str,
    sources: List[Dict[str, Any]],
    api_key: str,
    *,
    model: str = DEFAULT_MODEL,
    temperature: float = 0.2,
    transport: Optional[httpx.BaseTransport] = None,
    timeout: float = 120.0,
) -> Dict[str, Any]:
    prompt_text = (
        f"{JUDGE_PROMPT}\n\nTRANSCRIPT:\n{transcript}\n\n"
        f"SOURCES JSON:\n{json.dumps(sources, ensure_ascii=False)}"
    )
    try:
        text = _generate(
            prompt_text, api_key, model=model, temperature=temperature,
            transport=transport, timeout=timeout,
        )
    except Exception as e:
        raise RuntimeError(f"Gemini error: {e}") from e
    try:
        return json.loads(_clean_json_text(text))
    except json.JSONDecodeError as e:
        return {
            "verdict": "uncertain",
            "confidence": 0,
            "reasoning": f"Error parsing model response: {e}",
            "sources": [],
        }


def score_similarity(
    transcript: str,
    article_snippet: str,
    api_key: str,
    *,
    model: str = DEFAULT_MODEL,
    temperature: float = 0.2,
    transport: Optional[httpx.BaseTransport] = None,
    timeout: float = 120.0,
) -> float:
    """0-1 corroboration score between a transcript and one article snippet.

    The reference defines this prompt but never wires it up
    (server/web/prompts.py:198-225, flagged in SURVEY.md §2.1 #7); here it
    is a usable client with the same contract.  Returns 0.0 on parse
    failure (defensive, like judge_content's stub verdict).
    """
    from truely_tpu_torch.agents.prompts import SIMILARITY_PROMPT

    prompt_text = (
        f"{SIMILARITY_PROMPT}\n\nTRANSCRIPT:\n{transcript}\n\n"
        f"ARTICLE:\n{article_snippet}"
    )
    try:
        text = _generate(
            prompt_text, api_key, model=model, temperature=temperature,
            transport=transport, timeout=timeout,
        )
    except Exception as e:
        raise RuntimeError(f"Gemini error: {e}") from e
    try:
        score = float(json.loads(_clean_json_text(text)).get("score", 0.0))
    except (json.JSONDecodeError, TypeError, ValueError):
        return 0.0
    return min(max(score, 0.0), 1.0)


def generate_search_query(
    transcript: str,
    api_key: str,
    *,
    model: str = DEFAULT_MODEL,
    temperature: float = 0.2,
    transport: Optional[httpx.BaseTransport] = None,
    timeout: float = 120.0,
) -> str:
    prompt_text = f"{SEARCH_QUERY_PROMPT}\n\nTRANSCRIPT:\n{transcript}"
    try:
        text = _generate(
            prompt_text, api_key, model=model, temperature=temperature,
            transport=transport, timeout=timeout,
        )
    except Exception as e:
        raise RuntimeError(f"Gemini query generation error: {e}") from e

    def fallback() -> str:
        return " ".join(transcript.split()[:FALLBACK_QUERY_WORDS])

    try:
        data = json.loads(_clean_json_text(text))
        query = str(data.get("query", "")).strip() or fallback()
    except json.JSONDecodeError:
        query = fallback()
    return query[:QUERY_MAX_CHARS]
