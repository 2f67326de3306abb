"""Label vocabularies the serving path needs (copied from the JAX package's
`data/loaders.py`, whose package imports JAX; tests pin the copy)."""

A_GENRES = ['Classical', 'Rock', 'Pop', 'Folk', 'Metal', 'Electronic',
            'Hip-Hop', 'R&B', 'Blues', 'Jazz', 'Country']
