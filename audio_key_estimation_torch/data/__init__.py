"""Host side of the port: audio decode and ingest, the MP3 decoder,
corpus loaders, synthetic corpora and the dataset."""
