"""The LM substrate of the port: configuration (``config``), layers, the
dense decoder (``transformer``, with the mixture-of-experts FFN of
``moe``), the other families (``rwkv6``, ``mamba2`` + ``zamba2``,
``vision``, ``whisper``), the H^2 token mixer (``h2mixer``) and the family
dispatch (``api``)."""
