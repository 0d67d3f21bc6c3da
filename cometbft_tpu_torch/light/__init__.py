"""Light client (reference: light/): verifier, bisection client,
divergence detector, providers, trusted store — the port of
cometbft_tpu/light/ on the port's types, every commit check through the
verify service on the card."""

from .client import (
    SEQUENTIAL,
    SKIPPING,
    Client,
    ErrNoWitnesses,
    TrustOptions,
)
from .detector import (
    DivergenceError,
    ErrFailedHeaderCrossReferencing,
    ErrLightClientAttackDetected,
    detect_divergence,
)
from .provider import (
    BlockStoreProvider,
    ErrBadLightBlock,
    ErrHeightTooHigh,
    ErrLightBlockNotFound,
    Provider,
    ProviderError,
)
from .store import LightStore
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
    "Client",
    "TrustOptions",
    "SEQUENTIAL",
    "SKIPPING",
    "ErrNoWitnesses",
    "LightStore",
    "Provider",
    "BlockStoreProvider",
    "ProviderError",
    "ErrLightBlockNotFound",
    "ErrHeightTooHigh",
    "ErrBadLightBlock",
    "detect_divergence",
    "DivergenceError",
    "ErrLightClientAttackDetected",
    "ErrFailedHeaderCrossReferencing",
    "verify",
    "verify_adjacent",
    "verify_non_adjacent",
    "verify_backwards",
    "validate_trust_level",
    "header_expired",
    "DEFAULT_MAX_CLOCK_DRIFT_NS",
    "DEFAULT_TRUST_LEVEL",
    "LightClientError",
    "ErrInvalidHeader",
    "ErrInvalidTrustLevel",
    "ErrOldHeaderExpired",
    "ErrNewValSetCantBeTrusted",
]
