"""Typed exceptions (reference: src/exception/*, SURVEY N10)."""


class MeshclustError(Exception):
    """Base class for engine errors."""


class InvalidInputError(MeshclustError):
    """Bad user input (ref InvalidInputException)."""


class InvalidStateError(MeshclustError):
    """Engine invariant violated (ref InvalidStateException)."""


class InvalidOperationError(MeshclustError):
    """Operation not allowed in the current state (ref InvalidOperationException)."""


class InvalidOrderOfOperationsError(MeshclustError):
    """API misuse ordering (ref InvalidOrderOfOperationsException)."""


class InvalidScoreError(MeshclustError):
    """Bad alignment/score value (ref InvalidScoreException)."""


class FileDoesNotExistError(MeshclustError):
    """Missing input file (ref FileDoesNotExistException)."""
