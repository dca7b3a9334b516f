"""Container runtime layer (reference: @fluidframework/container-runtime,
datastore, id-compressor; SURVEY.md §2.8/§2.9/§2.11): ``container_runtime``
(op routing, the outbox, pending state), ``datastore``, ``outbox`` and its
inverse ``remote_message_processor``, ``pending_state``, ``id_compressor``,
``gc``, and ``summarizer`` (the summary generation store and the
summarization agent)."""
