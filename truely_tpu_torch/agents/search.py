"""Trusted-domain web search via Tavily (reference server/web/utils/search.py).

Note: the reference's TRUSTED_DOMAINS list has a missing comma that silently
concatenates "foxnews.com" and "aljazeera.com" into one bogus domain
(search.py:14-15, flagged in SURVEY.md §2.1 #5); fixed here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import httpx

TAVILY_SEARCH_URL = "https://api.tavily.com/search"

TRUSTED_DOMAINS = [
    "cnn.com",
    "bbc.com",
    "cbsnews.com",
    "foxnews.com",
    "aljazeera.com",
    "bloomberg.com",
]

# Result filtering: drop archive/old-dated URLs unless clearly current, and
# retrospective roundup titles (reference search.py:46-49).
_STALE_URL_PATTERNS = ("archive", "/19", "/200", "/201")
_FRESH_URL_PATTERNS = ("2024", "2025")
_STALE_TITLE_PATTERNS = ("this week", "looking back", "archives", "television this week")


def perform_search(
    query: str,
    api_key: str,
    max_results: int = 5,
    include_domains: Optional[List[str]] = None,
    *,
    transport: Optional[httpx.BaseTransport] = None,
    timeout: float = 60.0,
) -> List[Dict[str, Any]]:
    body = {
        "query": query,
        "max_results": max_results,
        "search_depth": "advanced",
        "include_answer": False,
        "include_raw_content": False,
    }
    domains = include_domains if include_domains is not None else TRUSTED_DOMAINS
    if domains:
        body["include_domains"] = domains
    with httpx.Client(timeout=timeout, transport=transport) as client:
        resp = client.post(
            TAVILY_SEARCH_URL,
            headers={"Authorization": f"Bearer {api_key}"},
            json=body,
        )
    if resp.status_code != 200:
        raise RuntimeError(
            f"web search request failed (HTTP {resp.status_code}): {resp.text}"
        )
    normalized: List[Dict[str, Any]] = []
    for r in resp.json().get("results", []):
        url = (r.get("url") or "").lower()
        title = (r.get("title") or "").lower()
        if any(p in url for p in _STALE_URL_PATTERNS) and not any(
            p in url for p in _FRESH_URL_PATTERNS
        ):
            continue
        if any(p in title for p in _STALE_TITLE_PATTERNS):
            continue
        normalized.append(
            {
                "title": r.get("title") or "",
                "url": r.get("url") or "",
                "snippet": r.get("content") or r.get("snippet") or "",
                "score": r.get("score"),
            }
        )
    return normalized
