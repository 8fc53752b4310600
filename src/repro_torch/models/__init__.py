"""The LM substrate of the port: configuration (``config``), layers, the
dense decoder (``transformer``), the H^2 token mixer (``h2mixer``) and the
family dispatch (``api``).  Only the dense family is ported so far."""
