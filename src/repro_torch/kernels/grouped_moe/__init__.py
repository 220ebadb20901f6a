"""B2: dropless ragged grouped expert FFN."""
