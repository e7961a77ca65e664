"""Model configurations of the LM stack: the schema (``base``) and the ten
architecture tables, resolved by name in ``registry``."""
