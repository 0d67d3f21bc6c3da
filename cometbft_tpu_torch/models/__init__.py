"""Verifiers of the commit path: the host oracle and the comb-cached batch verifier."""
