"""Light-client verification (reference: light/verifier.go): the header
checks of cometbft_tpu/light/verifier.py on the port's types."""

from .verifier import (
    DEFAULT_MAX_CLOCK_DRIFT_NS,
    DEFAULT_TRUST_LEVEL,
    ErrInvalidHeader,
    ErrInvalidTrustLevel,
    ErrNewValSetCantBeTrusted,
    ErrOldHeaderExpired,
    LightClientError,
    header_expired,
    validate_trust_level,
    verify,
    verify_adjacent,
    verify_backwards,
    verify_non_adjacent,
)

__all__ = [
    "DEFAULT_MAX_CLOCK_DRIFT_NS",
    "DEFAULT_TRUST_LEVEL",
    "ErrInvalidHeader",
    "ErrInvalidTrustLevel",
    "ErrNewValSetCantBeTrusted",
    "ErrOldHeaderExpired",
    "LightClientError",
    "header_expired",
    "validate_trust_level",
    "verify",
    "verify_adjacent",
    "verify_backwards",
    "verify_non_adjacent",
]
