"""The slice of the wire codec that canonical vote sign-bytes need."""
