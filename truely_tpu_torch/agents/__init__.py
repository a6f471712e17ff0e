"""Fact-check agents: transcription, web search, LLM judge (off the hot path),
copied from ``truely_tpu/agents/``.  They need ``httpx``; the server imports
them only when a request reaches them."""

from truely_tpu_torch.agents.transcribe import transcribe_audio  # noqa: F401
from truely_tpu_torch.agents.search import perform_search, TRUSTED_DOMAINS  # noqa: F401
from truely_tpu_torch.agents.judge import judge_content, generate_search_query  # noqa: F401
