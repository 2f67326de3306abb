"""Host-side audio ingest for the port: PCM16 WAV decode and batch packing."""
