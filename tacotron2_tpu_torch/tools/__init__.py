"""Tools of the port: the tone-corpus training demo and the quality gate."""
