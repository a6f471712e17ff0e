"""The port's fact-check agents (``truely_tpu_torch.agents``) against the
JAX package's (``truely_tpu.agents``) on the ``httpx.MockTransport`` cases
of ``tests/test_agents.py``: the same fake responses give the same results,
or the same errors, from both (no network)."""

import json

import httpx
import pytest
import torch

from truely_tpu.agents import judge as jjudge
from truely_tpu.agents import search as jsearch
from truely_tpu.agents import transcribe as jtranscribe
from truely_tpu_torch.agents import judge, search, transcribe
from truely_tpu_torch.agents.judge import _clean_json_text
from truely_tpu_torch.agents.search import TRUSTED_DOMAINS

torch.set_num_threads(2)


def both(port_fn, jax_fn, *args, **kw):
    """(port result, JAX result) of one call each on the same arguments;
    an exception is returned as (type, message)."""
    out = []
    for fn in (port_fn, jax_fn):
        try:
            out.append(fn(*args, **kw))
        except Exception as e:  # noqa: BLE001 — compared across the two packages
            out.append((type(e).__name__, str(e)))
    return out


def gemini_transport(text):
    return httpx.MockTransport(lambda request: httpx.Response(
        200, json={"candidates": [{"content": {"parts": [{"text": text}]}}]}))


def test_trusted_domains_fixed():
    assert TRUSTED_DOMAINS == jsearch.TRUSTED_DOMAINS
    assert "foxnews.com" in TRUSTED_DOMAINS and "aljazeera.com" in TRUSTED_DOMAINS
    assert len(TRUSTED_DOMAINS) == 6


@pytest.mark.parametrize("text", ['```json\n{"a": 1}\n```', '```\n{"a": 1}\n```',
                                  '"verdict": "Fake"', '{"a": 1}', "  ", "```json```", "x}"])
def test_clean_json_text(text):
    assert _clean_json_text(text) == jjudge._clean_json_text(text)


@pytest.mark.parametrize("text", [
    '```json\n{"verdict": "Misleading", "confidence": 60, "reasoning": "r", "sources": []}\n```',
    "not { json ]",
    '"verdict": "Fake", "confidence": 90',
])
def test_judge_content(text):
    got, want = both(judge.judge_content, jjudge.judge_content, "transcript",
                     [{"title": "t", "url": "u"}], "key", transport=gemini_transport(text))
    assert got == want and "verdict" in got


@pytest.mark.parametrize("status,body", [
    (500, {"text": "boom"}),
    (200, {"json": {"candidates": []}}),
    (200, {"json": {"nothing": 1}}),
])
def test_judge_content_errors(status, body):
    transport = httpx.MockTransport(lambda r: httpx.Response(status, **body))
    got, want = both(judge.judge_content, jjudge.judge_content, "t", [], "key",
                     transport=transport)
    assert got == want and got[0] == "RuntimeError" and "Gemini error" in got[1]


def test_judge_request_body():
    """Both send the same request: model URL, key, prompt, temperature and
    JSON mime type."""
    seen = []

    def handler(request):
        seen.append((str(request.url), json.loads(request.content)))
        return httpx.Response(200, json={"candidates": [{"content": {"parts": [{"text": "{}"}]}}]})

    both(judge.judge_content, jjudge.judge_content, "transcript", [{"title": "t"}], "k",
         transport=httpx.MockTransport(handler))
    assert len(seen) == 2 and seen[0] == seen[1]
    assert seen[0][1]["generationConfig"] == {"temperature": 0.2,
                                              "responseMimeType": "application/json"}


@pytest.mark.parametrize("text", ['{"query": "  the query  "}', '{"query": ""}', "garbage [",
                                  '{"query": "' + "y" * 500 + '"}', '{"other": 1}'])
@pytest.mark.parametrize("transcript", ["some transcript",
                                        " ".join(f"w{i}" for i in range(50)),
                                        " ".join("x" * 20 for _ in range(30))])
def test_generate_search_query(text, transcript):
    got, want = both(judge.generate_search_query, jjudge.generate_search_query, transcript,
                     "key", transport=gemini_transport(text))
    assert got == want and len(got) <= 350


def test_generate_search_query_fallback_words():
    words = " ".join(f"w{i}" for i in range(50))
    q = judge.generate_search_query(words, "key", transport=gemini_transport('{"query": ""}'))
    assert q == " ".join(f"w{i}" for i in range(30))


@pytest.mark.parametrize("text,want", [('{"score": 0.75}', 0.75), ('{"score": 7}', 1.0),
                                       ('{"score": -1}', 0.0), ("junk [", 0.0),
                                       ('{"score": "x"}', 0.0)])
def test_score_similarity(text, want):
    got, ref = both(judge.score_similarity, jjudge.score_similarity, "t", "a", "k",
                    transport=gemini_transport(text))
    assert got == ref == want


def test_perform_search_filtering():
    results = [
        {"title": "Fresh news", "url": "https://bbc.com/news/2025/x", "content": "body",
         "score": 0.9},
        {"title": "From the archives", "url": "https://cnn.com/archive/old", "content": "old",
         "score": 0.5},
        {"title": "Television this week", "url": "https://bbc.com/tv", "content": "listing",
         "score": 0.4},
        {"title": "2019 piece", "url": "https://cnn.com/2019/story", "content": "dated",
         "score": 0.3},
        {"title": None, "url": "https://cbsnews.com/2024/a", "snippet": "s"},
    ]

    def handler(request):
        body = json.loads(request.content)
        assert body["search_depth"] == "advanced"
        assert body["include_domains"] == TRUSTED_DOMAINS
        return httpx.Response(200, json={"results": results})

    got, want = both(search.perform_search, jsearch.perform_search, "q", "key",
                     transport=httpx.MockTransport(handler))
    assert got == want
    assert [r["title"] for r in got] == ["Fresh news", ""] and got[0]["snippet"] == "body"


def test_perform_search_error():
    transport = httpx.MockTransport(lambda r: httpx.Response(403, text="denied"))
    got, want = both(search.perform_search, jsearch.perform_search, "q", "key",
                     transport=transport)
    assert got == want == ("RuntimeError", "web search request failed (HTTP 403): denied")


@pytest.mark.parametrize("status,body,language", [
    (200, {"json": {"text": "hello world"}}, None),
    (200, {"json": {"text": "bonjour"}}, "fr"),
    (200, {"json": {"text": ""}}, None),
    (401, {"text": "bad key"}, None),
])
def test_transcribe(tmp_path, status, body, language):
    audio = tmp_path / "a.mp3"
    audio.write_bytes(b"audio")
    sent = []

    def handler(request):
        sent.append(request.content)
        return httpx.Response(status, **body)

    got, want = both(transcribe.transcribe_audio, jtranscribe.transcribe_audio, str(audio),
                     language, api_key="k", transport=httpx.MockTransport(handler))
    assert got == want
    assert b"whisper-large-v3-turbo" in sent[0]


def test_transcribe_missing_file(tmp_path):
    got, want = both(transcribe.transcribe_audio, jtranscribe.transcribe_audio,
                     str(tmp_path / "none.mp3"), api_key="k",
                     transport=httpx.MockTransport(lambda r: httpx.Response(200)))
    assert got == want and got[0] == "RuntimeError"
