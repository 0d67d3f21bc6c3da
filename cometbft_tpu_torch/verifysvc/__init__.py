"""The verify service's wire pieces the port needs so far: the CheckTx
signed-tx envelope (checktx.py).  The service itself is deferred."""
