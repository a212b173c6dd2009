"""Program analyses: producer/consumer maps (``usedef``), the static op
signatures (``signatures``) and the program verifier (``verify``) that
``io.save_inference_model`` runs before it writes."""
