"""Executor error policy (bounded retry + backoff for transient program
failures). The injection plane and checkpoint chains are not ported."""
from .policy import RetryPolicy, TransientFaultError  # noqa: F401
