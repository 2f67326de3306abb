"""Constants and label builders of the port: the key-signature map and
the key, signature and tonic labels."""
