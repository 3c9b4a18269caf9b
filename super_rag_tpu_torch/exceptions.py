"""Business exception taxonomy (port of the JAX package's exceptions.py).

Counterpart of the reference's exceptions.py (ErrorCode enum :6,
BusinessException :86 + domain exceptions :111-260).  HTTP handlers map
these onto status codes via `status`.
"""

from __future__ import annotations

import enum


class ErrorCode(str, enum.Enum):
    INVALID_ARGUMENT = "INVALID_ARGUMENT"
    NOT_FOUND = "NOT_FOUND"
    ALREADY_EXISTS = "ALREADY_EXISTS"
    PERMISSION_DENIED = "PERMISSION_DENIED"
    UNAUTHENTICATED = "UNAUTHENTICATED"
    QUOTA_EXCEEDED = "QUOTA_EXCEEDED"
    RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"
    FAILED_PRECONDITION = "FAILED_PRECONDITION"
    PROVIDER_ERROR = "PROVIDER_ERROR"
    INTERNAL = "INTERNAL"


_STATUS = {
    ErrorCode.INVALID_ARGUMENT: 422,
    ErrorCode.NOT_FOUND: 404,
    ErrorCode.ALREADY_EXISTS: 409,
    ErrorCode.PERMISSION_DENIED: 403,
    ErrorCode.UNAUTHENTICATED: 401,
    ErrorCode.QUOTA_EXCEEDED: 429,
    ErrorCode.RESOURCE_EXHAUSTED: 429,
    ErrorCode.FAILED_PRECONDITION: 409,
    ErrorCode.PROVIDER_ERROR: 502,
    ErrorCode.INTERNAL: 500,
}


class BusinessException(Exception):
    code = ErrorCode.INTERNAL

    def __init__(self, message: str = "", code: ErrorCode | None = None):
        super().__init__(message)
        if code is not None:
            self.code = code
        self.message = message

    @property
    def status(self) -> int:
        return _STATUS[self.code]


class CollectionNotFound(BusinessException):
    code = ErrorCode.NOT_FOUND


class DocumentNotFound(BusinessException):
    code = ErrorCode.NOT_FOUND


class QuotaExceeded(BusinessException):
    code = ErrorCode.QUOTA_EXCEEDED


class DuplicateDocument(BusinessException):
    code = ErrorCode.ALREADY_EXISTS


class PermissionDenied(BusinessException):
    code = ErrorCode.PERMISSION_DENIED


class InvalidConfig(BusinessException):
    code = ErrorCode.INVALID_ARGUMENT


class ProviderError(BusinessException):
    code = ErrorCode.PROVIDER_ERROR
