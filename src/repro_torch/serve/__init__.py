"""Network serving front-end: HTTP/JSON wire protocol over the
`ServingEngine` plus the semantic-model catalog and NL→AISQL
compilation layer (the paper's REST/chat entry points, §2)."""
from repro_torch.serve.semantic_model import (ColumnSpec,  # noqa: F401
                                              NL2SQLError,
                                              NL2SQLOperator,
                                              SemanticModel,
                                              SemanticValidationError,
                                              TableSpec, VerifiedQuery,
                                              question_corpus)
from repro_torch.serve.http import (AisqlHttpClient,  # noqa: F401
                                    AisqlHttpServer, HttpConfig,
                                    HttpError, ERROR_CONTRACT)
